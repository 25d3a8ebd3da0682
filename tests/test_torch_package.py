"""Package-level contracts of the PyTorch/CUDA port.

- Importing every ``cuzk_tpu_torch`` module imports neither jax nor
  ``cuzk_tpu`` and builds no kernel (checked in a fresh interpreter).
- Without a usable CUDA device the kernel entry points raise; a failed
  kernel build propagates instead of falling back to the plain versions.
- The port's constants, and those compiled into the CUDA header, are the
  oracle's (the CPU ``k``, not the reference CUDA code's).
- ``chip_smoke.py`` imports nothing of jax or ``cuzk_tpu``, fails without a
  card, and its golden values are the oracles'.
- The exception types and validators behave as ``cuzk_tpu.utils.errors``.
"""

import os
import re
import subprocess
import sys

import ast
import importlib.util
import shutil

import numpy as np
import pytest
import torch

from cuzk_tpu import native, oracle
from cuzk_tpu_torch import constants, merkle, poseidon
from cuzk_tpu_torch.ops import _build, poseidon_cuda
from cuzk_tpu_torch.utils import device as device_mod
from cuzk_tpu_torch.utils import errors, stats

CPU = "cpu"  # the CPU tests ask for the plain path by name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = [
    "cuzk_tpu_torch",
    "cuzk_tpu_torch.constants",
    "cuzk_tpu_torch.oracle",
    "cuzk_tpu_torch.field",
    "cuzk_tpu_torch.field.fr",
    "cuzk_tpu_torch.field.batch",
    "cuzk_tpu_torch.poseidon",
    "cuzk_tpu_torch.merkle",
    "cuzk_tpu_torch.native",
    "cuzk_tpu_torch.engine",
    "cuzk_tpu_torch.ops",
    "cuzk_tpu_torch.ops._build",
    "cuzk_tpu_torch.ops.poseidon_cuda",
    "cuzk_tpu_torch.utils",
    "cuzk_tpu_torch.utils.errors",
    "cuzk_tpu_torch.utils.stats",
    "cuzk_tpu_torch.utils.device",
    "cuzk_tpu_torch.utils.io",
    "cuzk_tpu_torch.bench",
    "cuzk_tpu_torch.bench.headline",
    "cuzk_tpu_torch.bench.run",
    "cuzk_tpu_torch.bench.cli",
    "cuzk_tpu_torch.bench.profile",
    "cuzk_tpu_torch.bench.mp_scaling",
    "cuzk_tpu_torch.parallel",
    "cuzk_tpu_torch.parallel.distributed",
]


def test_import_pulls_no_jax_and_builds_nothing():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from cuzk_tpu_torch.ops import _build\n"
        "from cuzk_tpu_torch import native\n"
        "assert _build._kernels is None and native._lib is None\n"
        "assert native._oracle_lib is None\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'cuzk_tpu')))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_kernels", None)


def test_package_serves_every_subpackage_lazily():
    """``cuzk_tpu_torch.parallel``, ``.native`` and ``.oracle`` resolve
    through the package, as ``cuzk_tpu``'s do, in a fresh interpreter that
    then holds no jax, no ``cuzk_tpu`` and nothing built."""
    code = (
        "import sys\n"
        "import cuzk_tpu_torch as p\n"
        "assert set(p.__all__) >= {'oracle', 'parallel', 'native'}\n"
        "mods = [p.parallel, p.native, p.oracle, p.field, p.bench]\n"
        "assert p.oracle.hash_pair(10, 20) == int('2dd359f92d31c747e06c02b3"
        "60a9f5c761777b285edcf09724efef5cbd51d9ba', 16)\n"
        "assert callable(p.parallel.sharded_build_levels)\n"
        "assert p.native._lib is None and p.native._oracle_lib is None\n"
        "from cuzk_tpu_torch.ops import _build\n"
        "assert _build._kernels is None\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'cuzk_tpu')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    import cuzk_tpu
    import cuzk_tpu_torch

    assert set(cuzk_tpu.__all__) == set(cuzk_tpu_torch.__all__)
    with pytest.raises(AttributeError):
        cuzk_tpu_torch.nonesuch


def test_slice6_entries_raise_without_a_gpu(no_cuda):
    """The int helpers, the batch field ops, the new suites and a forced
    kernel engine raise without a card; nothing falls back to the CPU."""
    from cuzk_tpu_torch.bench import run
    from cuzk_tpu_torch.field.batch import BatchFieldArithmetic

    with pytest.raises(errors.CudaUnavailableError):
        poseidon.hash_pair_int(10, 20)
    with pytest.raises(errors.CudaUnavailableError):
        poseidon.hash_multiple_int([])
    with pytest.raises(errors.CudaUnavailableError):
        BatchFieldArithmetic().batch_subtract(np.zeros((2, 16), np.uint32),
                                              np.zeros((2, 16), np.uint32))
    meta = torch.zeros((2, 16), dtype=torch.int64, device="meta")
    with pytest.raises(errors.CudaUnavailableError):
        poseidon_cuda.fr_op_cuda("sub", meta, meta)
    host = np.zeros((2, 16), np.uint32)
    with pytest.raises(errors.CudaUnavailableError):
        poseidon_cuda.fr_op_cuda("sub", host, host)
    for suite in ("verify", "compare", "sweep"):
        with pytest.raises(errors.CudaUnavailableError):
            run.main(["--suite", suite, "--skip-verify"])
    with pytest.raises(errors.CudaUnavailableError):
        run.run_hardware_verify()
    with merkle.engine_path("kernel"):
        with pytest.raises(errors.CudaUnavailableError):
            merkle._engine_hash_multiple(meta[:, None])


def test_cuda_entries_raise_without_a_gpu(no_cuda):
    with pytest.raises(errors.CudaUnavailableError):
        device_mod.require_cuda()
    with pytest.raises(errors.CudaUnavailableError):
        _build.kernels()
    with pytest.raises(errors.CudaUnavailableError):
        device_mod.device_info()
    assert not device_mod.check_cuda_compatibility()
    meta = torch.zeros((4, 16), dtype=torch.int64, device="meta")
    with pytest.raises(errors.CudaUnavailableError):
        poseidon_cuda.hash_pair_cuda(meta, meta)
    with pytest.raises(errors.CudaUnavailableError):
        poseidon_cuda.sponge_limbs(torch.zeros((4, 2, 8), dtype=torch.int32), 2)
    with pytest.raises(errors.CudaUnavailableError):
        merkle.verify_proofs(
            torch.zeros((4, 1), dtype=torch.int32, device="meta"),
            torch.zeros((4, 1, 1, 16), dtype=torch.int64, device="meta"),
            meta, torch.zeros(16, dtype=torch.int64, device="meta"), 2,
        )
    digits = torch.zeros((4, 16), dtype=torch.int64)
    with pytest.raises(errors.CudaUnavailableError):
        poseidon_cuda.verify_digits(
            torch.zeros((4, 1), dtype=torch.int32), digits[:, None, None],
            digits, digits[0], 2,
        )


@pytest.mark.parametrize("name", ["ValidationError", "ComputationError", "IndexError_"])
def test_error_types_mirror_cuzk_tpu(name):
    from cuzk_tpu.utils import errors as jerrors

    ours, theirs = getattr(errors, name), getattr(jerrors, name)
    assert ours.__bases__ == theirs.__bases__


@pytest.mark.parametrize("call", [
    ("validate_range", (5, 2, 8)),
    ("validate_range", (9, 2, 8)),
    ("validate_index", (3, 4)),
    ("validate_index", (4, 4)),
    ("validate_index", (-1, 4)),
    ("validate_non_empty", ([1],)),
    ("validate_non_empty", ([],)),
])
def test_validators_mirror_cuzk_tpu(call):
    from cuzk_tpu.utils import errors as jerrors

    name, args = call

    def outcome(mod):
        try:
            return "ok", getattr(mod, name)(*args)
        except (ValueError, IndexError) as e:
            return type(e).__name__, str(e)

    assert outcome(errors) == outcome(jerrors)


def test_timed_returns_result_and_seconds():
    out, seconds = stats.timed(torch.add, torch.ones(3), 1)
    assert torch.equal(out, torch.full((3,), 2.0))
    assert seconds >= 0.0


def test_build_failure_propagates(monkeypatch, tmp_path):
    """A compiler error surfaces as KernelBuildError with its output, and a
    wrapper given a non-CPU tensor raises it rather than running plain."""

    def broken_nvcc(cmd, **kwargs):
        return subprocess.CompletedProcess(
            cmd, 1, stdout="", stderr="nvcc: error: simulated compiler failure")

    monkeypatch.setattr(device_mod, "require_cuda", lambda: None)
    monkeypatch.setattr(_build, "require_cuda", lambda: None)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", broken_nvcc)
    monkeypatch.setattr(_build, "_kernels", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(errors.KernelBuildError, match="simulated compiler"):
        _build.kernels()
    meta = torch.zeros((2, 3, 16), dtype=torch.int64, device="meta")
    with pytest.raises(errors.KernelBuildError):
        poseidon_cuda.hash_multiple_cuda(meta)
    assert _build._kernels is None


def test_header_constants_are_the_oracles():
    text = ""
    for name in _build.HEADERS:
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            text += f.read()

    def limbs(name):
        body = re.search(rf"#define {name} \\\n(.*)\\\n(.*)\n", text)
        body = body.group(1) + body.group(2)
        words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]
        assert len(words) == 8
        return sum(w << (32 * i) for i, w in enumerate(words))

    assert limbs("FR254_P") == oracle.P
    assert limbs("FR254_P2") == 2 * oracle.P
    assert limbs("FR254_P4") == 4 * oracle.P
    assert limbs("FR254_K") == oracle.K == (1 << 256) % oracle.P
    mds = re.search(r"mds\[T \* T\] = \{([^}]*)\}", text).group(1)
    assert tuple(int(v) for v in mds.split(",")) == oracle.MDS


def test_constants_are_the_oracles():
    assert (constants.P, constants.K) == (oracle.P, oracle.K)
    assert constants.RC == oracle.RC
    assert constants.MDS == oracle.MDS
    for name in ("T", "RATE", "FULL_ROUNDS", "PARTIAL_ROUNDS", "TOTAL_ROUNDS",
                 "DS_SINGLE", "DS_PAIR", "DS_MULTIPLE", "MIN_ARITY",
                 "MAX_ARITY"):
        assert getattr(constants, name) == getattr(oracle, name), name


def test_round_constant_table_for_the_kernels():
    rc = np.ascontiguousarray(poseidon.RC_LIMBS, np.uint32)
    assert rc.shape == (64, 3, 8)
    flat = rc.reshape(-1, 8).astype(np.uint64)
    assert [sum(int(w) << (32 * i) for i, w in enumerate(r)) for r in flat] == oracle.RC


def test_sources_ship_with_the_package():
    for name in _build.SOURCES + _build.HEADERS:
        assert os.path.exists(os.path.join(_build.CSRC_DIR, name))
    with open(os.path.join(REPO, "pyproject.toml")) as f:
        project = f.read()
    assert "cuzk_tpu_torch*" in project
    assert "csrc/*.cu" in project and "csrc/*.cuh" in project
    from cuzk_tpu_torch import native as port_native

    assert os.path.exists(port_native.SOURCE) and "native/*.cpp" in project
    assert os.path.exists(port_native.ORACLE_SOURCE)
    assert os.path.exists(os.path.join(REPO, "cuzk_tpu_torch", "PARITY.md"))


def test_launch_counts_reset():
    assert {"sponge", "verify", "permutation"} <= set(poseidon_cuda.launch_counts)
    for name in poseidon_cuda.launch_counts:
        poseidon_cuda.launch_counts[name] = 3
    poseidon_cuda.reset_launch_counts()
    assert set(poseidon_cuda.launch_counts.values()) == {0}


def test_slice2_entries_raise_without_a_gpu(no_cuda):
    """The engines, the CUDA entry points of slice 2 and the benchmark
    CLIs raise without a card; nothing falls back to the CPU."""
    from cuzk_tpu_torch import engine
    from cuzk_tpu_torch.bench import profile, run

    with pytest.raises(errors.CudaUnavailableError):
        engine.CudaPoseidonEngine()
    with pytest.raises(errors.CudaUnavailableError):
        engine.CoalescingPoseidonEngine()
    with pytest.raises(errors.CudaUnavailableError):
        engine.verify_engines_match()
    with pytest.raises(errors.CudaUnavailableError):
        poseidon_cuda.permutation_cuda(np.zeros((4, 3, 16), np.uint32))
    meta = torch.zeros((4, 3, 16), dtype=torch.int64, device="meta")
    with pytest.raises(errors.CudaUnavailableError):
        poseidon_cuda.permutation_cuda(meta)
    with pytest.raises(errors.CudaUnavailableError):
        poseidon_cuda.hash_pair_cuda_packed(meta[:, 0, :8], meta[:, 0, :8])
    with pytest.raises(errors.CudaUnavailableError):
        poseidon_cuda.hash_single_cuda_loop(meta[:, 0], 2)
    with pytest.raises(errors.CudaUnavailableError):
        run.main(["--suite", "poseidon"])
    with pytest.raises(errors.CudaUnavailableError):
        profile.main(["1024", "1", "pairs"])


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _load_chip_smoke()


def test_chip_smoke_imports_no_jax_package():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "cuzk_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "cuzk_tpu"}


def test_chip_smoke_fails_alone_without_a_card(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        cwd=tmp_path, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize(
    "op,args,want", CHIP_SMOKE.GOLDEN,
    ids=[f"{op}-{i}" for i, (op, _, _) in enumerate(CHIP_SMOKE.GOLDEN)],
)
def test_chip_smoke_golden_values_are_the_oracles(op, args, want):
    assert getattr(oracle, op)(*args) == want


def test_chip_smoke_50k_root_is_the_native_oracles():
    leaves = oracle.generate_test_leaves(50_000, 42)
    assert native.merkle_root(leaves, 4) == CHIP_SMOKE.ROOT_50K_ARITY4


def test_chip_smoke_262144_root_is_the_native_oracles():
    """The golden node of the 1M-leaf arity-8 tree: its first 8^6 leaves
    are generate_test_leaves(262144, 42), so their root is node 0 of its
    level 6 (the whole tree's root would cost the oracle minutes)."""
    assert oracle.generate_test_leaves(262_144, 42) == \
        oracle.generate_test_leaves(CHIP_SMOKE.LEAVES_1M, 42)[:8 ** 6]
    leaves = oracle.generate_test_leaves(262_144, 42)
    assert native.merkle_root(leaves, 8) == CHIP_SMOKE.ROOT_262144_ARITY8
    assert (CHIP_SMOKE.LEAVES_1M, CHIP_SMOKE.ARITY_1M) == (1_048_576, 8)


def test_parallel_package_is_found_and_exports_the_jax_names():
    import setuptools

    import cuzk_tpu.parallel as jparallel
    import cuzk_tpu_torch.parallel as parallel

    found = setuptools.find_packages(REPO, include=["cuzk_tpu_torch*"])
    assert "cuzk_tpu_torch.parallel" in found
    assert set(jparallel.__all__) | {
        "sharded_generate_proofs", "initialize_multiprocess"
    } == set(parallel.__all__)
    for name in parallel.__all__:
        assert callable(getattr(parallel, name))


def test_scheduler_build_failure_propagates(monkeypatch, tmp_path):
    """A g++ error surfaces as KernelBuildError with the compiler's output,
    and the dedup verify raises it: there is no other grouping route."""
    from cuzk_tpu_torch import native

    broken = tmp_path / "scheduler.cpp"
    broken.write_text("int cuzk_group_rows( {\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(errors.KernelBuildError, match="error"):
        native.load()
    assert native._lib is None
    pos = np.zeros((64, 2), np.int32)
    sib = np.zeros((64, 2, 1, 16), np.uint32)
    leaves = np.zeros((64, 16), np.uint32)
    with pytest.raises(errors.KernelBuildError):
        merkle.verify_each(pos, sib, leaves, leaves[0], 2, device=CPU)
