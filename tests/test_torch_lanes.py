"""The card as the default device, the choice of lanes per state, the
verify route of proofs by where they lie, and the kernels' build record.

CPU tests: with no card, every public entry point given host data and no
``device`` raises :class:`CudaUnavailableError`, and runs the plain path
only for ``device="cpu"`` or CPU tensors.  Verdicts are held against the
JAX package.
"""

import os
import re

import numpy as np
import pytest
import torch

from cuzk_tpu import merkle as jmerkle
from cuzk_tpu import oracle
from cuzk_tpu_torch import engine, merkle
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import _build, poseidon_cuda
from cuzk_tpu_torch.utils import errors

CPU = "cpu"  # the CPU tests ask for the plain path by name


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_kernels", None)


def _leaves(n, seed=1):
    return np.random.default_rng(seed).integers(0, 1 << 16, (n, 16)).astype(
        np.uint32)


def _proofs(n=20, arity=4, idx=(0, 3, 7, 19)):
    tree = merkle.NaryMerkleTree(_leaves(n), merkle.MerkleConfig(arity),
                                 device=CPU)
    pos, sib = tree.generate_batch_proofs(list(idx))
    return tree, pos, sib, tree.levels[0][list(idx)]


@pytest.mark.parametrize("entry", [
    "tree", "build_tree_levels", "merkle_root", "merkle_root_empty",
    "from_levels", "build_batch_trees", "benchmark_tree", "verify_each",
    "verify_all", "verify_proofs", "hash_pair_cuda", "hash_single_cuda",
    "hash_multiple_cuda", "hash_pair_cuda_packed", "permutation_cuda",
    "hash_single_cuda_loop", "torch_engine",
])
def test_host_data_goes_to_the_card_and_raises_without_one(entry, no_cuda):
    x = _leaves(5)
    _, pos, sib, proved = _proofs()
    host = (pos.numpy(), sib.numpy().astype(np.uint32),
            proved.numpy().astype(np.uint32), proved.numpy()[0])
    calls = {
        "tree": lambda: merkle.NaryMerkleTree(x),
        "build_tree_levels": lambda: merkle.build_tree_levels(x, 2),
        "merkle_root": lambda: merkle.merkle_root(x, 2),
        "merkle_root_empty": lambda: merkle.merkle_root(x[:0], 2),
        "from_levels": lambda: merkle.NaryMerkleTree.from_levels(
            [x[:4], x[:2], x[:1]], 2, 4),
        "build_batch_trees": lambda: merkle.build_batch_trees([x, x], 2),
        "benchmark_tree": lambda: merkle.benchmark_tree(8, 2, num_proofs=2),
        "verify_each": lambda: merkle.verify_each(*host, 4),
        "verify_all": lambda: merkle.verify_all(*host, 4),
        "verify_proofs": lambda: merkle.verify_proofs(*host, 4),
        "hash_pair_cuda": lambda: poseidon_cuda.hash_pair_cuda(x, x),
        "hash_single_cuda": lambda: poseidon_cuda.hash_single_cuda(x),
        "hash_multiple_cuda": lambda: poseidon_cuda.hash_multiple_cuda(x[None]),
        "hash_pair_cuda_packed": lambda: poseidon_cuda.hash_pair_cuda_packed(
            fr.pack16_host(x), fr.pack16_host(x)),
        "permutation_cuda": lambda: poseidon_cuda.permutation_cuda(
            x[:3].reshape(1, 3, 16)),
        "hash_single_cuda_loop": lambda: poseidon_cuda.hash_single_cuda_loop(x, 2),
        "torch_engine": lambda: engine.TorchPoseidonEngine(),
    }
    with pytest.raises(errors.CudaUnavailableError):
        calls[entry]()


def test_load_tree_defaults_to_the_card(no_cuda, tmp_path):
    path = str(tmp_path / "t.npz")
    merkle.save_tree(merkle.NaryMerkleTree(_leaves(9), device=CPU), path)
    with pytest.raises(errors.CudaUnavailableError):
        merkle.load_tree(path)
    loaded = merkle.load_tree(path, verify=True, device=CPU)
    assert loaded.levels[0].device.type == "cpu"


def test_cpu_by_name_or_by_tensor_runs_the_plain_path(no_cuda):
    x = _leaves(6)
    want = oracle.merkle_root(
        [sum(int(d) << (16 * i) for i, d in enumerate(row)) for row in x], 2)
    by_name = merkle.NaryMerkleTree(x, device=CPU)
    by_tensor = merkle.NaryMerkleTree(torch.as_tensor(x.astype(np.int64)))
    assert by_name.root_int() == by_tensor.root_int() == want
    assert by_tensor.levels[0].device.type == "cpu"
    out = poseidon_cuda.hash_pair_cuda(torch.as_tensor(x.astype(np.int64)),
                                       torch.as_tensor(x.astype(np.int64)))
    assert out.device.type == "cpu"
    assert engine.TorchPoseidonEngine(device=CPU).device.type == "cpu"


@pytest.mark.parametrize("resident", [1, 7, 1024, 67_584, 84_480, 101_376])
def test_choose_lanes_is_one_at_a_wave_and_more_below(resident):
    choose = poseidon_cuda.choose_lanes
    for batch in (resident, resident + 1, 2 * resident, 10 * resident):
        assert choose(batch, resident) == 1
    for batch in range(1, resident // poseidon_cuda.SPLIT_FRACTION + 1,
                       max(1, resident // 50)):
        assert choose(batch, resident) == poseidon_cuda.SPLIT_LANES > 1
    for batch in (resident // 4, resident // 2, resident - 1):
        if batch * poseidon_cuda.SPLIT_FRACTION > resident:
            assert choose(batch, resident) == 1
    assert poseidon_cuda.SPLIT_LANES in poseidon_cuda.LANES


def test_choose_lanes_at_the_swept_shapes():
    """The sweep's winners on an H100 (101,376 sponge and 84,480 verify
    states a wave): the split for 64-4,096 arity groups or pairs and for
    500-2,500 proofs, one thread from 6,144 groups and 5,000 proofs."""
    choose = poseidon_cuda.choose_lanes
    assert [choose(b, 101_376) for b in
            (64, 1024, 4096, 6144, 8192, 16384, 65536, 262144)] \
        == [3, 3, 3, 1, 1, 1, 1, 1]
    assert [choose(b, 84_480) for b in (500, 2500, 5000, 50000)] == [3, 3, 1, 1]


def test_lanes_argument_is_checked():
    assert poseidon_cuda.LANES == (1, poseidon_cuda.SPLIT_LANES)
    for forced in (0, 2, 4, 8):
        with pytest.raises(errors.ValidationError, match="lanes"):
            poseidon_cuda._lanes(forced, 10, torch.device("cuda", 0), "sponge")
    for forced in poseidon_cuda.LANES:
        assert poseidon_cuda._lanes(forced, 10, torch.device("cuda", 0),
                                    "sponge") == forced


@pytest.mark.parametrize("arity", [2, 4])
def test_verify_batch_proofs_on_cpu_tensors_gives_jax_verdicts(arity):
    xs = _leaves(40, 7 + arity)
    tree = merkle.NaryMerkleTree(torch.as_tensor(xs.astype(np.int64)),
                                 merkle.MerkleConfig(arity))
    jtree = jmerkle.NaryMerkleTree(xs, jmerkle.MerkleConfig(arity))
    idx = list(range(0, 40, 3))
    pos, sib = tree.generate_batch_proofs(idx)
    proved = tree.levels[0][idx]
    jpos, jsib = (np.asarray(a) for a in jtree.generate_batch_proofs(idx))
    jproved = np.asarray(jtree.levels[0])[idx]
    assert tree.verify_batch_proofs(pos, sib, proved)
    assert jtree.verify_batch_proofs(jpos, jsib, jproved)
    bad = proved.clone()
    bad[4, 0] ^= 1
    jbad = jproved.copy()
    jbad[4, 0] ^= 1
    assert not tree.verify_batch_proofs(pos, sib, bad)
    assert not jtree.verify_batch_proofs(jpos, jsib, jbad)
    each = merkle.verify_each(pos, sib, bad, tree.get_root_hash(), arity)
    jeach = np.asarray(jmerkle.verify_each(jpos, jsib, jbad,
                                           np.asarray(jtree.levels[-1][0]),
                                           arity))
    assert np.array_equal(each, jeach) and np.flatnonzero(~each).tolist() == [4]


def test_card_resident_proofs_skip_the_host_schedule(monkeypatch):
    """Proofs on the card go to one per-proof verify call where they lie,
    with no host copy.  The CPU run fakes the card's placement and lets the
    plain path stand in for the kernel."""
    tree, pos, sib, proved = _proofs()
    calls = []
    real = merkle.verify_proofs

    def k3(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(merkle, "verify_proofs", k3)
    monkeypatch.setattr(merkle, "_on_card", lambda *xs: True)
    monkeypatch.setattr(merkle, "_host",
                        lambda x: pytest.fail("host copy of card proofs"))
    assert tree.verify_batch_proofs(pos, sib, proved) and len(calls) == 1
    bad = proved.clone()
    bad[2, 0] ^= 1
    got = merkle.verify_each(pos, sib, bad, tree.get_root_hash(), 4)
    assert got.tolist() == [True, True, False, True] and len(calls) == 2


def test_card_resident_proofs_honour_an_explicit_device(monkeypatch):
    """Proofs on the card with ``device=`` given verify on that device, not
    where they lie.  The CPU run fakes the card's placement."""
    tree, pos, sib, proved = _proofs()
    devices = []
    real = merkle.verify_proofs

    def k3(*args, device=None):
        devices.append(device)
        return real(*args, device=device)

    monkeypatch.setattr(merkle, "verify_proofs", k3)
    monkeypatch.setattr(merkle, "_on_card", lambda *xs: True)
    bad = proved.clone()
    bad[1, 0] ^= 1
    root = tree.get_root_hash()
    got = merkle.verify_each(pos, sib, bad, root, 4, device=CPU)
    assert got.tolist() == [True, False, True, True]
    assert not merkle.verify_all(pos, sib, bad, root, 4, device=CPU)
    assert merkle.verify_each(pos, sib, bad, root, 4).tolist() == got.tolist()
    assert devices == [CPU, CPU, None]


def test_header_constants_are_p_multiples_and_k():
    with open(os.path.join(_build.CSRC_DIR, "fr254.cuh")) as f:
        text = f.read()

    def value(name):
        m = re.search(rf"#define {name} \\\n(.*)\\\n(.*)\n", text)
        words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u",
                                                m.group(1) + m.group(2))]
        assert len(words) == 8, name
        return sum(w << (32 * i) for i, w in enumerate(words))

    assert value("FR254_P") == oracle.P
    assert value("FR254_P2") == 2 * oracle.P
    assert value("FR254_P4") == 4 * oracle.P
    assert value("FR254_K") == oracle.K == (1 << 256) - 5 * oracle.P


def test_ptxas_record_parses():
    log = """ptxas info    : 0 bytes gmem, 2304 bytes cmem[3]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113sponge_kernelILi3EEEvPKjPjlij' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113sponge_kernelILi3EEEvPKjPjlij
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 396 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125permutation_digits_kernelEPKlPll' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125permutation_digits_kernelEPKlPll
    16 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 376 bytes cmem[0]
"""
    assert _build.parse_ptxas(log) == {
        "sponge_kernel<3>": {"stack_frame": 0, "spill_stores": 0,
                             "spill_loads": 0, "registers": 64},
        "permutation_digits_kernel": {"stack_frame": 16, "spill_stores": 4,
                                      "spill_loads": 8, "registers": 128},
    }


@pytest.mark.parametrize("op", sorted(poseidon_cuda.FR_OPS))
def test_fr_op_on_cpu_tensors_runs_the_plain_op(op):
    """The check kernel's wrapper on CPU tensors is the plain ``fr`` op,
    held against the oracle on reduced operands and c = 26."""
    rng = np.random.default_rng(90)
    a = fr.red(torch.as_tensor(rng.integers(0, 1 << 16, (4, 16))))
    b = fr.red(torch.as_tensor(rng.integers(0, 1 << 16, (4, 16))))
    ai, bi = fr.array_to_ints(a), fr.array_to_ints(b)
    if op == "reduce_wide":
        got = poseidon_cuda.fr_op_cuda(op, fr.mul_wide(a, b))
        want = [oracle.mul(x, y) for x, y in zip(ai, bi)]
    elif op in ("mul_small", "mul_small_rr"):
        got = poseidon_cuda.fr_op_cuda(op, a, c=26)
        want = [oracle.mul(x, 26) for x in ai]
    elif op in ("square", "power5", "red"):
        got = poseidon_cuda.fr_op_cuda(op, a)
        want = {"square": [oracle.mul(x, x) for x in ai],
                "power5": [oracle.power5(x) for x in ai],
                "red": ai}[op]
    else:
        got = poseidon_cuda.fr_op_cuda(op, a, b)
        ref = {"mul": oracle.mul, "sub": oracle.sub}.get(op, oracle.add)
        want = [ref(x, y) for x, y in zip(ai, bi)]
    assert got.device.type == "cpu" and fr.array_to_ints(got) == want
