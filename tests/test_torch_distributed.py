"""The port's sharded build, proofs and hashing against the JAX package.

``cuzk_tpu_torch.parallel.distributed`` runs one process a rank, so the
2- and 4-rank cases spawn this file itself with ``--worker``: each rank
runs on the CPU (``device="cpu"``, gloo, the plain sponge), joins a
``file://`` rendezvous in the test's temp directory and writes its blocks
to ``rank<i>.npz`` there.  The test joins the blocks in rank order and
holds them against

- ``cuzk_tpu.parallel.distributed`` on ``make_mesh(d)`` of the 8 virtual
  CPU devices, as the JAX package's own tests run it, and
- the single-device builds of both packages.

Inputs are made from a seed with numpy, digits below 2^16.  Every
comparison is of integers: tolerance zero.
"""

import json
import os
import sys

CPU = "cpu"  # the CPU tests ask for the plain path by name


def seeded_leaves(count, seed):
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, 1 << 16, (count, 16), dtype=np.uint32)


def _worker(argv):
    """One rank: ``--worker <case json> <rank>``."""
    import numpy as np
    import torch

    from cuzk_tpu_torch.parallel import distributed

    case, rank = json.loads(argv[0]), int(argv[1])
    if case.get("fail_rank") == rank:
        sys.exit(7)  # before any collective: the others would wait for it
    torch.set_num_threads(1)
    distributed.initialize_multiprocess(
        "", case["ranks"], rank, init_method="file://" + case["store"],
        device=CPU, timeout_s=120)
    mesh = distributed.make_mesh(device=CPU)
    assert (mesh.size, mesh.rank, mesh.backend) == (case["ranks"], rank, "gloo")
    out = {}
    leaves = seeded_leaves(case["leaves"], case["seed"])
    arity = case["arity"]
    if case["leaves"] == 0:
        try:
            distributed.sharded_build_levels(leaves, arity, mesh)
        except ValueError as e:
            out["raised"] = np.array(str(e))
    else:
        sharded, replicated = distributed.sharded_build_levels(
            leaves, arity, mesh)
        for i, lv in enumerate(sharded):
            out[f"sharded{i}"] = lv.numpy()
        for i, lv in enumerate(replicated):
            out[f"replicated{i}"] = lv.numpy()
        pos, sib = distributed.sharded_generate_proofs(
            sharded, replicated, arity, case["indices"], mesh)
        out["pos"], out["sib"] = pos.numpy(), sib.numpy()
        root = replicated[-1][0]
        if case.get("root"):
            root = distributed.sharded_merkle_root(leaves, arity, mesh)
        out["root"] = root.numpy()
    if case.get("hash"):
        n = case["hash"]
        l, r = seeded_leaves(n, 5), seeded_leaves(n, 6)
        pairs = distributed.sharded_hash_pairs(l, r, mesh)
        out["pairs"] = pairs.numpy()
        out["pairs_unsharded"] = distributed.unshard(pairs, mesh).numpy()
        as_i32 = torch.as_tensor(l.astype(np.int64)).to(torch.int32)
        block = distributed.shard_batch(as_i32, mesh)
        assert block.dtype == torch.int64
        out["block"] = block.numpy()
        out["single"] = distributed.sharded_hash_single(as_i32, mesh).numpy()
    if case.get("sub"):
        # Every rank of the world calls make_mesh; those outside get None.
        sub = distributed.make_mesh(case["sub"], device=CPU)
        out["sub_size"] = np.array(-1 if sub is None else sub.size)
        if sub is not None:
            assert (sub.rank, sub.backend) == (rank, "gloo")
            out["sub_root"] = distributed.sharded_merkle_root(
                leaves, arity, sub).numpy()
    np.savez(os.path.join(case["dir"], f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        _worker(sys.argv[2:])
        sys.exit(0)
    sys.exit("run under pytest, or as a rank with --worker")


import subprocess  # noqa: E402
import time  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from cuzk_tpu import merkle as jmerkle  # noqa: E402
from cuzk_tpu import poseidon as jposeidon  # noqa: E402
from cuzk_tpu.parallel import distributed as jdist  # noqa: E402
from cuzk_tpu_torch import merkle  # noqa: E402
from cuzk_tpu_torch.bench import mp_scaling  # noqa: E402
from cuzk_tpu_torch.parallel import distributed  # noqa: E402
from cuzk_tpu_torch.utils import errors  # noqa: E402

SPAWN_TIMEOUT_S = 300

# name -> the case each rank runs.  (arity 8, 64 leaves, 2 ranks) leaves
# r = 4 rows a rank at the gather; (3, 5, 4) pads to 9 rows, which 4 ranks
# do not divide (the replicated fallback); (2, 20, 2) pads to 32.
CASES = {
    "a2_n32_d4": dict(arity=2, leaves=32, ranks=4, seed=1,
                      indices=[0, 3, 7, 12, 31, 31, 17], hash=16, root=True),
    "a4_n16_d4": dict(arity=4, leaves=16, ranks=4, seed=2,
                      indices=[0, 5, 15, 9, 9], sub=2),
    "a8_n64_d2": dict(arity=8, leaves=64, ranks=2, seed=3,
                      indices=[63, 0, 8, 8, 31]),
    "fallback_a3_n5_d4": dict(arity=3, leaves=5, ranks=4, seed=4,
                              indices=[0, 4, 8, 4]),
    "padded_a2_n20_d2": dict(arity=2, leaves=20, ranks=2, seed=5,
                             indices=[19, 20, 31, 0]),
}
_results = {}


def spawn(case, tmp_dir):
    """Run ``case`` at its rank count; each rank's arrays, in rank order."""
    case = dict(case, dir=str(tmp_dir), store=str(tmp_dir / "store"))
    commands = [
        [sys.executable, os.path.abspath(__file__), "--worker",
         json.dumps(case), str(rank)]
        for rank in range(case["ranks"])
    ]
    mp_scaling.launch(commands, SPAWN_TIMEOUT_S, env=mp_scaling.worker_env())
    out = []
    for rank in range(case["ranks"]):
        with np.load(tmp_dir / f"rank{rank}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


@pytest.fixture
def ranks_of(tmp_path_factory):
    """``ranks_of(name)``: the spawned ranks' arrays of a case, run once."""
    def get(name):
        if name not in _results:
            _results[name] = spawn(CASES[name], tmp_path_factory.mktemp(name))
        return _results[name]
    return get


def joined_levels(ranks):
    """``sharded_levels[:-1] + replicated_levels`` with the ranks' blocks
    joined in rank order; every rank's replicated levels must be equal."""
    def named(prefix):
        n = sum(k.startswith(prefix) for k in ranks[0])
        return [[r[f"{prefix}{i}"] for r in ranks] for i in range(n)]

    sharded, replicated = named("sharded"), named("replicated")
    for per_rank in replicated:
        for other in per_rank[1:]:
            np.testing.assert_array_equal(other, per_rank[0])
    if sharded:
        # replicated[0] is the gathered version of sharded[-1].
        np.testing.assert_array_equal(np.concatenate(sharded[-1]),
                                      replicated[0][0])
    return ([np.concatenate(blocks) for blocks in sharded[:-1]]
            + [per_rank[0] for per_rank in replicated])


def assert_levels_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_levels_equal_the_jax_packages(name, ranks_of):
    case = CASES[name]
    leaves = seeded_leaves(case["leaves"], case["seed"])
    got = joined_levels(ranks_of(name))
    sharded, replicated = jdist.sharded_build_levels(
        leaves, case["arity"], jdist.make_mesh(case["ranks"]))
    assert_levels_equal(got, list(sharded[:-1]) + list(replicated))
    assert_levels_equal(
        got, jmerkle.build_tree_levels(jnp.asarray(leaves), case["arity"]))
    # The split into sharded and replicated levels is the JAX package's.
    n_sharded = sum(k.startswith("sharded") for k in ranks_of(name)[0])
    assert n_sharded == len(sharded)
    assert (n_sharded == 0) == name.startswith("fallback")


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_levels_equal_the_single_device_build(name, ranks_of):
    case = CASES[name]
    leaves = seeded_leaves(case["leaves"], case["seed"])
    want = merkle.build_tree_levels(leaves, case["arity"], device=CPU)
    assert_levels_equal(joined_levels(ranks_of(name)),
                        [lv.numpy() for lv in want])
    for rank in ranks_of(name):
        np.testing.assert_array_equal(rank["root"], want[-1][0].numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_proofs_equal_both_packages_and_verify(name, ranks_of):
    case = CASES[name]
    arity, idx = case["arity"], np.array(case["indices"], np.int32)
    leaves = seeded_leaves(case["leaves"], case["seed"])
    ranks = ranks_of(name)
    for rank in ranks[1:]:
        np.testing.assert_array_equal(rank["pos"], ranks[0]["pos"])
        np.testing.assert_array_equal(rank["sib"], ranks[0]["sib"])
    pos, sib = ranks[0]["pos"], ranks[0]["sib"]
    levels = merkle.build_tree_levels(leaves, arity, device=CPU)
    want_pos, want_sib = merkle.generate_proofs(levels, arity, idx)
    assert pos.dtype == np.int32 and sib.dtype == np.int64
    np.testing.assert_array_equal(pos, want_pos.numpy())
    np.testing.assert_array_equal(sib, want_sib.numpy())
    sharded, replicated = jdist.sharded_build_levels(
        leaves, arity, mesh := jdist.make_mesh(case["ranks"]))
    jpos, jsib = jdist.sharded_generate_proofs(sharded, replicated, arity,
                                               idx, mesh)
    np.testing.assert_array_equal(pos, np.asarray(jpos))
    np.testing.assert_array_equal(sib, np.asarray(jsib))
    ok = merkle.verify_proofs(pos, sib, levels[0][torch.as_tensor(idx).long()],
                              torch.as_tensor(ranks[0]["root"]), arity,
                              device=CPU)
    assert bool(ok.all())


def test_sharded_hashes_equal_the_jax_packages(ranks_of):
    ranks = ranks_of("a2_n32_d4")
    n = CASES["a2_n32_d4"]["hash"]
    l, r = seeded_leaves(n, 5), seeded_leaves(n, 6)
    pairs = np.concatenate([rank["pairs"] for rank in ranks])
    np.testing.assert_array_equal(
        pairs, np.asarray(jposeidon.hash_pair(jnp.asarray(l), jnp.asarray(r))))
    single = np.concatenate([rank["single"] for rank in ranks])
    np.testing.assert_array_equal(
        single, np.asarray(jposeidon.hash_single(jnp.asarray(l))))
    mesh = jdist.make_mesh(len(ranks))
    np.testing.assert_array_equal(
        pairs, np.asarray(jdist.sharded_hash_pairs(l, r, mesh)))
    # unshard: every rank holds the whole, in rank order.
    for rank in ranks:
        np.testing.assert_array_equal(rank["pairs_unsharded"], pairs)


def test_shard_batch_normalises_an_int32_tensor(ranks_of):
    """Tensors convert too (the case tests/test_distributed.py pins for
    device arrays): int32 in, the port's int64 digits out, block by block."""
    ranks = ranks_of("a2_n32_d4")
    l = seeded_leaves(CASES["a2_n32_d4"]["hash"], 5)
    assert ranks[0]["block"].dtype == np.int64
    np.testing.assert_array_equal(
        np.concatenate([rank["block"] for rank in ranks]), l)


def test_a_sub_mesh_takes_the_first_ranks(ranks_of):
    """make_mesh(2) in a world of 4: ranks 0 and 1 build on a group of
    their own, ranks 2 and 3 get None."""
    ranks = ranks_of("a4_n16_d4")
    assert [int(r["sub_size"]) for r in ranks] == [2, 2, -1, -1]
    case = CASES["a4_n16_d4"]
    want = merkle.merkle_root(seeded_leaves(case["leaves"], case["seed"]),
                              case["arity"], device=CPU).numpy()
    for rank in ranks[:2]:
        np.testing.assert_array_equal(rank["sub_root"], want)
    assert "sub_root" not in ranks[2] and "sub_root" not in ranks[3]


def test_empty_input_raises_on_every_rank(tmp_path):
    ranks = spawn(dict(arity=2, leaves=0, ranks=2, seed=0, indices=[]),
                  tmp_path)
    assert [str(r["raised"]) for r in ranks] == [
        "cannot shard-build an empty tree"] * 2
    with pytest.raises(ValueError, match="empty tree"):
        distributed.sharded_build_levels(
            np.zeros((0, 16), np.uint32), 2, distributed.make_mesh(device=CPU))
    with pytest.raises(ValueError, match="empty tree"):
        jdist.sharded_build_levels(np.zeros((0, 16), np.uint32), 2,
                                   jdist.make_mesh(2))


def test_a_failing_rank_makes_the_launcher_raise_and_leaves_no_process(
        tmp_path, monkeypatch):
    case = dict(CASES["a4_n16_d4"], dir=str(tmp_path),
                store=str(tmp_path / "store"), fail_rank=1)
    commands = [
        [sys.executable, os.path.abspath(__file__), "--worker",
         json.dumps(case), str(rank)]
        for rank in range(case["ranks"])
    ]
    started = []
    popen = subprocess.Popen

    def recording(*args, **kwargs):
        started.append(popen(*args, **kwargs))
        return started[-1]

    monkeypatch.setattr(mp_scaling.subprocess, "Popen", recording)
    start = time.monotonic()
    with pytest.raises(RuntimeError, match=r"worker 1 failed \(exit 7\)"):
        mp_scaling.launch(commands, 120, env=mp_scaling.worker_env())
    # Well inside the timeout: the other ranks were killed, not waited for.
    assert time.monotonic() - start < 60
    assert len(started) == 4
    assert all(p.returncode is not None for p in started)


def test_launcher_times_out_and_reaps():
    cmd = [sys.executable, "-c", "import time; time.sleep(60)"]
    start = time.monotonic()
    with pytest.raises(subprocess.TimeoutExpired):
        mp_scaling.launch([cmd, cmd], 1.0)
    assert time.monotonic() - start < 30


# ---------------------------------------------------------------------------
# The one-rank mesh, in this process (no process group, no launcher).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arity,count", [(2, 32), (8, 64), (3, 5)])
def test_one_rank_mesh_builds_the_single_device_tree(arity, count):
    mesh = distributed.make_mesh(device=CPU)
    assert (mesh.size, mesh.rank, mesh.group, mesh.backend) == (1, 0, None, None)
    assert mesh.axis_name == distributed.DATA_AXIS and not mesh.shared_card
    leaves = seeded_leaves(count, 11)
    sharded, replicated = distributed.sharded_build_levels(leaves, arity, mesh)
    want = merkle.build_tree_levels(leaves, arity, device=CPU)
    assert_levels_equal([lv.numpy() for lv in sharded[:-1] + replicated],
                        [lv.numpy() for lv in want])
    # One rank holds the whole tree locally: only the root is "replicated".
    assert len(replicated) == 1 and len(sharded) == len(want)
    jsharded, jreplicated = jdist.sharded_build_levels(
        leaves, arity, jdist.make_mesh(1))
    assert_levels_equal([lv.numpy() for lv in sharded[:-1] + replicated],
                        list(jsharded[:-1]) + list(jreplicated))
    idx = [0, count - 1, 1, 1]
    pos, sib = distributed.sharded_generate_proofs(sharded, replicated, arity,
                                                   idx, mesh)
    want_pos, want_sib = merkle.generate_proofs(want, arity, idx)
    assert torch.equal(pos, want_pos) and torch.equal(sib, want_sib)
    root = distributed.sharded_merkle_root(leaves, arity, mesh)
    assert torch.equal(root, want[-1][0])


def test_one_leaf_tree_has_height_zero_proofs():
    mesh = distributed.make_mesh(device=CPU)
    leaves = seeded_leaves(1, 12)
    sharded, replicated = distributed.sharded_build_levels(leaves, 4, mesh)
    pos, sib = distributed.sharded_generate_proofs(sharded, replicated, 4,
                                                   [0, 0], mesh)
    want_pos, want_sib = merkle.generate_proofs(
        merkle.build_tree_levels(leaves, 4, device=CPU), 4, [0, 0])
    assert pos.shape == want_pos.shape == (2, 0) and pos.dtype == want_pos.dtype
    assert sib.shape == want_sib.shape == (2, 0, 3, 16)
    assert sib.dtype == want_sib.dtype


def test_proof_index_out_of_range_raises():
    mesh = distributed.make_mesh(device=CPU)
    sharded, replicated = distributed.sharded_build_levels(
        seeded_leaves(4, 13), 2, mesh)
    with pytest.raises(IndexError):
        distributed.sharded_generate_proofs(sharded, replicated, 2, [4], mesh)


def test_make_mesh_asking_for_more_ranks_than_there_are_raises():
    with pytest.raises(ValueError, match="requested 2 devices, only 1"):
        distributed.make_mesh(2, device=CPU)
    with pytest.raises(ValueError, match="requested 9 devices, only 8"):
        jdist.make_mesh(9)


def test_shard_batch_wants_an_even_split():
    mesh = distributed.Mesh(None, 1, 3, torch.device(CPU), None)
    with pytest.raises(ValueError, match="evenly"):
        distributed.shard_batch(np.zeros((4, 16), np.uint32), mesh)
    block = distributed.shard_batch(np.arange(6 * 16).reshape(6, 16), mesh)
    assert block.tolist() == np.arange(6 * 16).reshape(6, 16)[2:4].tolist()


def test_bad_arity_raises_before_any_work():
    mesh = distributed.make_mesh(device=CPU)
    with pytest.raises(errors.ValidationError):
        distributed.sharded_build_levels(seeded_leaves(4, 1), 9, mesh)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(errors.CudaUnavailableError):
        distributed.make_mesh()
    with pytest.raises(errors.CudaUnavailableError):
        distributed.initialize_multiprocess("localhost:1", 1, 0)
    with pytest.raises(errors.CudaUnavailableError):
        mp_scaling.main(["--procs", "1"])


def test_backend_follows_the_ranks_placement(monkeypatch):
    """gloo for ranks on the CPU or sharing a card, NCCL when each rank
    owns one; sharing is read from where the ranks are placed (card ``rank
    % cards`` with no device, else the named card for all), not from the
    number of cards alone."""
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    for cards, ranks, device, shared, backend in [
        (1, 4, CPU, False, "gloo"),
        (1, 4, None, True, "gloo"),
        (1, 1, None, False, "nccl"),
        (1, 1, "cuda:0", False, "nccl"),
        (4, 4, None, False, "nccl"),
        (4, 5, None, True, "gloo"),
        (4, 4, "cuda:0", True, "gloo"),  # every rank on the named card
        (4, 2, "cuda:3", True, "gloo"),
        (4, 1, "cuda:3", False, "nccl"),
    ]:
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=cards: n)
        assert distributed.ranks_share_a_card(ranks, device) == shared
        assert distributed.choose_backend(ranks, device) == backend
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    assert distributed.choose_backend(4, None) == "gloo"


# ---------------------------------------------------------------------------
# The launcher round trip (the counterpart of tests/test_mp_scaling.py).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nproc", [1, 2])
def test_run_build_round_trip(nproc):
    res = mp_scaling.run_build(nproc, 16 * nproc, 2, 1, device=CPU,
                               timeout_s=300)
    assert res["suite"] == "weak_scaling_mp"
    assert (res["devices"], res["processes"]) == (nproc, nproc)
    assert res["leaves"] == res["padded_leaves"] == 16 * nproc
    assert res["build_ms"] > 0 and res["leaves_per_s"] > 0
    assert set(res["stages"]) == {"barrier_ms", "shard_ms", "local_levels_ms",
                                  "gather_ms", "replicated_tail_ms"}
    assert res["backend"] == "gloo" and not res["shared_card"]
    assert res["card"] == "cpu" and res["sponge_launches_per_build"] == 0
    leaves = np.random.default_rng(17).integers(
        0, 1 << 16, (16 * nproc, 16), dtype=np.uint32)
    assert res["root0"] == int(merkle.merkle_root(leaves, 2, device=CPU)[0])


def test_throughput_counts_the_padded_leaves():
    """At arity 8, 3 leaves pad to 8: the rate is 8 leaves over the build
    time, and the weak-scaling ratios are taken on such rates."""
    res = mp_scaling.run_build(1, 3, 8, 1, device=CPU, timeout_s=300)
    assert (res["leaves"], res["padded_leaves"]) == (3, 8)
    assert res["leaves_per_s"] == pytest.approx(8 / (res["build_ms"] / 1e3))
    row = mp_scaling.with_efficiency(dict(res, devices=4, processes=4),
                                     res["leaves_per_s"] / 2)
    assert row["efficiency_serialized"] == pytest.approx(2.0)
    assert row["efficiency"] == pytest.approx(0.5)


def test_run_build_wants_an_iteration():
    with pytest.raises(ValueError, match="iters"):
        mp_scaling.run_build(1, 16, 2, 0, device=CPU)
