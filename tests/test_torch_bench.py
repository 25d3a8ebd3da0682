"""The port's benchmark suite on the CPU: the plumbing only.

``cuzk_tpu_torch.bench.run`` runs the plain versions on CPU tensors, so its
gates and records can be checked here at toy sizes; no number it gives on
the CPU is a device metric.  Records carry the keys of the JAX suite's
records (``cuzk_tpu.bench.run``), plus the card.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from cuzk_tpu_torch import merkle
from cuzk_tpu_torch.bench import profile, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

POSEIDON_KEYS = {
    "suite", "mode", "path", "pipelined", "batch", "total_hashes",
    "ns_per_hash", "hashes_per_s", "hashes_per_s_p50", "hashes_per_s_best",
    "vs_baseline",
}
RESIDENT_KEYS = {
    "suite", "mode", "batch", "total_hashes", "device_loop_iters",
    "ns_per_hash", "hashes_per_s", "vs_baseline",
}
MERKLE_KEYS = {
    "suite", "leaves", "arity", "build_ms", "build_ms_p50", "build_ms_min",
    "leaves_per_s",
}
# Every min beside its mean.
PROOF_KEYS = {
    "batch_verify": {"verify_ms", "verify_ms_min", "proofs_per_s",
                     "all_valid", "paths_consistent"},
    "batch_verify_resident": {"schedule_ms", "schedule_ms_min", "upload_ms",
                              "upload_ms_min", "device_ms", "device_ms_min",
                              "device_sync_ms", "software_ms",
                              "software_ms_min", "upload_bytes",
                              "unique_jobs"},
    "batch_verify_tampered": {"isolated_ms", "isolated_ms_min", "honest_ms",
                              "honest_ms_min", "full_exact_ms",
                              "full_exact_ms_min", "flagged",
                              "tampered_index"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_verify_paths_match_on_cpu():
    assert run.verify_paths_match(batch=8, device="cpu")


@pytest.mark.parametrize("mode,pipeline", [
    ("pairs", None), ("single", None), ("pairs", False),
])
def test_bench_poseidon_record(mode, pipeline):
    res = run.bench_poseidon(8, 16, mode, pipeline, device="cpu")
    assert POSEIDON_KEYS <= set(res)
    assert res["pipelined"] == (pipeline is None)  # batch 8 coalesces
    assert res["bit_exact"] and res["card"] == "cpu" and res["path"] == "torch"
    assert res["total_hashes"] == 16 and res["hashes_per_s"] > 0


def test_bench_poseidon_resident_record():
    res = run.bench_poseidon_resident(8, 16, "single", samples=1, device="cpu")
    assert RESIDENT_KEYS <= set(res)
    assert res["device_loop_iters"] == 2


def test_bench_merkle_build_record():
    res = run.bench_merkle_build(17, 4, iters=1, device="cpu")
    assert MERKLE_KEYS <= set(res)
    assert (res["leaves"], res["arity"]) == (17, 4)
    assert "vs_baseline" not in res  # only the 50K build has a baseline


def test_summary_prints_every_row(capsys):
    rows = [
        {"suite": "poseidon", "mode": "pairs", "batch": 8, "pipelined": True,
         "ns_per_hash": 2.0, "hashes_per_s": 5e8, "vs_baseline": 233.1},
        {"suite": "merkle_build", "leaves": 17, "arity": 4, "build_ms": 1.5,
         "leaves_per_s": 1e4},
    ]
    run._print_summary(rows, torch.device("cpu"))
    out = capsys.readouterr().out
    assert "pairs batch=8 (coalesced)" in out and "17 leaves a=4" in out
    assert "Best pair-hash throughput" in out


def test_configs_are_the_references():
    assert run.POSEIDON_CONFIGS == [
        (512, 10_000, "Small Scale"),
        (1024, 100_000, "Medium Scale"),
        (4096, 1_000_000, "Large Scale"),
    ]
    assert profile.COMPREHENSIVE_CONFIGS == [
        (1024, 100), (8192, 50), (32768, 20), (65536, 10)]


def test_proof_generation_record():
    res = run.bench_proof_generation(8, 16, 2, iters=1, device="cpu")
    assert {"gen_ms", "gen_ms_min", "proofs_per_s", "proof_levels"} <= set(res)
    assert res["proof_levels"] == 4 and res["card"] == "cpu"


@pytest.mark.parametrize("dedupe", [None, False, True])
def test_batch_verify_record_and_gate(dedupe):
    res = run.bench_batch_verify(12, 16, 4, iters=1, dedupe=dedupe,
                                 device="cpu")
    assert PROOF_KEYS["batch_verify"] <= set(res)
    assert res["all_valid"] and res["paths_consistent"]
    assert "vs_baseline" not in res  # only the 5K verify has a baseline


def test_batch_verify_resident_and_tampered_records():
    res = run.bench_batch_verify_resident(12, 16, 4, iters=1, device="cpu")
    assert PROOF_KEYS["batch_verify_resident"] <= set(res)
    assert res["all_valid"] and res["upload_bytes"] > 0
    res = run.bench_batch_verify_tampered(12, 16, 4, iters=1, device="cpu")
    assert PROOF_KEYS["batch_verify_tampered"] <= set(res)
    assert res["flagged"] == [res["tampered_index"]] == [6]


def test_incremental_update_and_tree_matrix_records():
    res = run.bench_incremental_update(16, 4, k=3, iters=1, device="cpu")
    assert res["roots_consistent"] and res["updates"] == 3
    assert {"update_ms", "update_ms_min", "rebuild_ms", "rebuild_ms_min",
            "speedup_vs_rebuild"} <= set(res)
    rows = run.bench_tree_matrix(((16, 2),), num_proofs=4, device="cpu")
    assert rows[0]["suite"] == "benchmark_tree"
    assert (rows[0]["leaf_count"], rows[0]["tree_height"]) == (16, 5)


def test_summary_prints_the_proof_rows(capsys):
    rows = [
        {"suite": "batch_verify", "proofs": 5000, "arity": 4,
         "verify_ms": 12.5, "verify_ms_min": 11.0, "proofs_per_s": 4e5,
         "vs_baseline": 1.18},
        {"suite": "batch_verify_tampered", "proofs": 50000, "arity": 4,
         "isolated_ms": 40.0, "full_exact_ms": 90.0, "honest_ms": 38.0},
        {"suite": "incremental_update", "updates": 64, "leaves": 50000,
         "arity": 4, "update_ms": 2.0, "update_ms_min": 1.8,
         "speedup_vs_rebuild": 5.0},
    ]
    run._print_summary(rows, torch.device("cpu"))
    out = capsys.readouterr().out
    assert "12.500 ms (min 11.000)" in out
    assert "1 of 50000 tampered a=4" in out and "5.00x vs rebuild" in out


SCALING_KEYS = {
    "suite", "processes", "devices", "leaves", "padded_leaves", "arity",
    "build_ms", "leaves_per_s", "stages", "backend", "shared_card", "card",
    "sponge_launches_per_build", "efficiency", "efficiency_serialized",
}


def test_weak_scaling_rows_on_two_cpu_ranks():
    """1 then 2 ranks of 3 leaves each at arity 4: 3 leaves pad to 4, 6 to
    16, and the ratios are taken on the padded rates."""
    rows = run.bench_weak_scaling(3, 4, max_devices=2, iters=1, device="cpu",
                                  timeout_s=300)
    assert [r["devices"] for r in rows] == [1, 2]
    assert [(r["leaves"], r["padded_leaves"]) for r in rows] == [(3, 4), (6, 16)]
    for r in rows:
        assert SCALING_KEYS <= set(r) and r["suite"] == "weak_scaling"
        assert r["backend"] == "gloo" and not r["shared_card"]
        assert r["leaves_per_s"] == pytest.approx(
            r["padded_leaves"] / (r["build_ms"] / 1e3))
    assert rows[0]["efficiency"] == rows[0]["efficiency_serialized"] == 1.0
    assert rows[1]["efficiency_serialized"] == pytest.approx(
        rows[1]["leaves_per_s"] / rows[0]["leaves_per_s"])
    assert rows[1]["efficiency"] == pytest.approx(
        rows[1]["efficiency_serialized"] / 2)


def test_summary_prints_the_scaling_rows(capsys):
    rows = [
        {"suite": "weak_scaling", "leaves": 1048576, "arity": 8, "devices": 4,
         "backend": "gloo", "shared_card": True, "build_ms": 40.0,
         "leaves_per_s": 5e7, "efficiency": 0.2, "efficiency_serialized": 0.8},
        {"suite": "sharded_build", "leaves": 64, "arity": 2, "devices": 1,
         "backend": "nccl", "shared_card": False, "build_ms": 2.0,
         "leaves_per_s": 3e4},
    ]
    run._print_summary(rows, torch.device("cpu"))
    out = capsys.readouterr().out
    assert "1048576 leaves a=8 d=4 (gloo, shared card)" in out
    assert "eff 0.200, serialized 0.800" in out
    assert "64 leaves a=2 d=1 (nccl)" in out


def test_the_suites_the_cli_offers():
    assert run.NORTH_STAR_BUILD == (1_048_576, 8)
    assert merkle.padded_leaf_count(*run.NORTH_STAR_BUILD) == 8 ** 7
    for suite in ("all", "poseidon", "merkle", "proofs", "updates", "trees",
                  "scaling", "compare", "sweep", "verify"):
        assert f"--suite {suite}" in run.__doc__
    with pytest.raises(SystemExit):
        run.main(["--suite", "nonesuch"])
    with pytest.raises(SystemExit):
        run.main(["--suite", "poseidon", "--sync", "--path", "plain"])


# ---------------------------------------------------------------------------
# The compare, sweep and verify suites and the CLI on the CPU
# ---------------------------------------------------------------------------

def test_compare_suite_through_main(capsys):
    rows = run.main(["--suite", "compare", "--leaves", "3", "--arity", "4",
                     "--device", "cpu", "--skip-verify"])
    (res,) = rows
    assert res["suite"] == "merkle_compare" and res["trees_consistent"]
    assert (res["leaves"], res["arity"], res["card"]) == (3, 4, "cpu")
    assert res["accelerated_ms"] > 0 and res["reference_path_ms"] > 0
    assert "merkle_compare" in capsys.readouterr().out


def test_compare_raises_when_the_trees_differ(monkeypatch):
    """The in-bench check fails the run: a plain path that gives another
    root makes ``main`` exit non-zero."""
    real = merkle._build_levels

    def wrong_when_plain(padded, arity, trees=1):
        levels = real(padded, arity, trees)
        if merkle._PATH_OVERRIDE:
            levels[-1] = levels[-1] ^ 1
        return levels

    monkeypatch.setattr(merkle, "_build_levels", wrong_when_plain)
    with pytest.raises(SystemExit, match="differ"):
        run.main(["--suite", "compare", "--leaves", "5", "--arity", "2",
                  "--device", "cpu", "--skip-verify"])


def test_sweep_suite_through_main():
    rows = run.main(["--suite", "sweep", "--arities", "2,4", "--sizes",
                     "64,256", "--proofs", "16", "--device", "cpu",
                     "--skip-verify"])
    builds = [(r["arity"], r["leaves"]) for r in rows
              if r["suite"] == "merkle_build"]
    verifies = [(r["arity"], r["leaves"], r["proofs"], r["dedupe"])
                for r in rows if r["suite"] == "batch_verify"]
    assert builds == [(2, 64), (2, 256), (4, 64), (4, 256)]
    assert verifies == [(2, 256, 16, False), (4, 256, 16, False)]
    # The sweep's verify rows skip the plain host gate.
    assert all(r["all_valid"] and r["paths_consistent"] is None for r in rows
               if r["suite"] == "batch_verify")
    assert run.SWEEP_ARITIES == tuple(range(2, 9))
    assert run.SWEEP_SIZES == (64, 256, 1024, 4096)


def test_sweep_exits_when_honest_proofs_are_declined(monkeypatch):
    real = run.bench_batch_verify

    def declining(*args, **kwargs):
        res = real(*args, **kwargs)
        return dict(res, all_valid=res["arity"] != 4)

    monkeypatch.setattr(run, "bench_batch_verify", declining)
    with pytest.raises(SystemExit, match=r"arity \[4\]"):
        run.main(["--suite", "sweep", "--arities", "2,4", "--sizes", "16",
                  "--proofs", "4", "--device", "cpu", "--skip-verify"])


def test_verify_suite_writes_its_artifact(tmp_path):
    out = tmp_path / "CUDA_VERIFY.json"
    rows = run.main(["--suite", "verify", "--batch", "64", "--leaves", "9",
                     "--proofs", "8", "--verify-out", str(out),
                     "--device", "cpu", "--skip-verify"])
    with open(out) as f:
        art = json.load(f)
    assert rows[-1]["all_ok"] and art["all_ok"]
    assert art["device"] == "cpu" and art["backend"] == "cpu"
    assert art["n_random_inputs"] == 64 and art["stress"] is False
    assert art["tree"] == {"leaves": 9, "arities": [2, 4, 8], "proofs": 8}
    want = {f"{op}_{way}_vs_oracle"
            for op in ("pairs", "single", "multiple", "permutation")
            for way in ("kernel", "plain", "native")}
    want |= {"golden_hash_single_42", "golden_hash_pair_10_20",
             "build_arity2_vs_oracle", "build_arity4_vs_oracle",
             "build_arity8_vs_oracle", "merkle_root_native_vs_oracle",
             "verify_kernel_all_valid",
             "verify_kernel_detects_tamper", "dedup_all_valid",
             "dedup_detects_tamper"}
    assert set(art["checks"]) == want and all(art["checks"].values())
    assert run.VERIFY_OUT == os.path.join("chiprun_out", "CUDA_VERIFY.json")


def test_verify_suite_fails_loudly(monkeypatch, tmp_path):
    """A wrong kernel output fails its check, and ``main`` exits non-zero
    naming it."""
    real = run.pc.hash_pair_cuda
    monkeypatch.setattr(run.pc, "hash_pair_cuda",
                        lambda l, r: real(l, r) ^ 1)
    with pytest.raises(SystemExit, match="pairs_kernel_vs_oracle"):
        run.main(["--suite", "verify", "--batch", "8", "--leaves", "5",
                  "--proofs", "2", "--verify-out", str(tmp_path / "v.json"),
                  "--device", "cpu", "--skip-verify"])
    with open(tmp_path / "v.json") as f:
        art = json.load(f)
    assert not art["all_ok"] and not art["checks"]["pairs_kernel_vs_oracle"]
    assert not art["checks"]["golden_hash_pair_10_20"]


def test_cli_alias_runs_main():
    from cuzk_tpu_torch.bench import cli

    assert cli.main is run.main
    out = subprocess.run(
        [sys.executable, "-m", "cuzk_tpu_torch.bench.cli", "--help"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and "--suite" in out.stdout


def test_plain_path_rows(capsys):
    """``--path plain`` runs the poseidon suite on the plain sponge,
    synchronously, and says so in its rows."""
    rows = run.main(["--suite", "poseidon", "--path", "plain", "--batch", "8",
                     "--total", "16", "--device", "cpu", "--skip-verify"])
    assert [r["mode"] for r in rows] == ["pairs", "single"]
    for r in rows:
        assert r["path"] == "torch" and not r["pipelined"] and r["bit_exact"]
        assert r["label"] == "Custom" and r["total_hashes"] == 16
    rows = run.main(["--suite", "poseidon", "--path", "plain", "--pipeline",
                     "--mode", "pairs", "--batch", "8", "--total", "16",
                     "--device", "cpu", "--skip-verify"])
    assert rows[0]["pipelined"] and rows[0]["path"] == "torch"


def test_device_option_runs_the_cpu_and_defaults_to_the_card(monkeypatch):
    rows = run.main(["--suite", "poseidon", "--mode", "single", "--batch",
                     "8", "--total", "8", "--device", "cpu", "--skip-verify"])
    assert rows[0]["card"] == "cpu" and rows[0]["path"] == "torch"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from cuzk_tpu_torch.utils import errors

    with pytest.raises(errors.CudaUnavailableError):
        run.main(["--suite", "compare"])


def test_time_fn_is_the_mean_of_time_fn_stats():
    calls = []
    sec = run.time_fn(lambda x: calls.append(x), 3, device="cpu", iters=4,
                      warmup=1)
    assert calls == [3] * 5 and sec >= 0.0
