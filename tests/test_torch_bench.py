"""The port's benchmark suite on the CPU: the plumbing only.

``cuzk_tpu_torch.bench.run`` runs the plain versions on CPU tensors, so its
gates and records can be checked here at toy sizes; no number it gives on
the CPU is a device metric.  Records carry the keys of the JAX suite's
records (``cuzk_tpu.bench.run``), plus the card.
"""

import pytest
import torch

from cuzk_tpu_torch.bench import profile, run

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
