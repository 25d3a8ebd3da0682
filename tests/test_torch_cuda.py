"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA Hopper card and skips without one.  The
file imports no jax, so on a machine with a card and no jax it runs with

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Tolerance: none — every comparison is integer-exact.
"""

import numpy as np
import pytest
import torch

from cuzk_tpu import oracle
from cuzk_tpu_torch import merkle, poseidon
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.ops import _build, poseidon_cuda
from cuzk_tpu_torch.utils import errors

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def digits(rng, shape, device):
    return torch.as_tensor(
        rng.integers(0, 1 << 16, tuple(shape) + (16,)), device=device
    )


def test_kernels_build_into_the_build_dir(cuda_device):
    kernels = _build.kernels()
    assert kernels.path.startswith(_build.BUILD_DIR)


@pytest.mark.parametrize("op", sorted(poseidon_cuda.FR_OPS))
def test_fr_op_kernel_matches_plain(op, cuda_device):
    rng = np.random.default_rng(19)
    a = digits(rng, (4096,), cuda_device)
    b = fr.red(digits(rng, (4096,), cuda_device))
    plain = poseidon_cuda.FR_OPS[op][1]
    if op == "reduce_wide":
        w = fr.mul_wide(a, b)
        got, want = poseidon_cuda.fr_op_cuda(op, w), plain(w)
    elif op == "mul_small":
        got, want = poseidon_cuda.fr_op_cuda(op, a, c=23), plain(a, 23)
    elif op == "mul_small_rr":
        got, want = poseidon_cuda.fr_op_cuda(op, b, c=23), plain(b, 23)
    elif op == "add_rr":
        ra = fr.red(a)
        got, want = poseidon_cuda.fr_op_cuda(op, ra, b), plain(ra, b)
    elif op in ("mul", "add_wrap_red", "sub"):
        got, want = poseidon_cuda.fr_op_cuda(op, a, b), plain(a, b)
    else:
        got, want = poseidon_cuda.fr_op_cuda(op, a), plain(a)
    assert torch.equal(got, want)


def test_reduced_mul_small_at_its_edge(cuda_device):
    """a = p - 1, c = 26: a c >> 256 = 4, the largest high word, and the
    second fold is still never needed."""
    a = fr.ints_to_array([oracle.P - 1] * 8, device=cuda_device)
    assert (oracle.P - 1) * 26 >> 256 == 4
    got = poseidon_cuda.fr_op_cuda("mul_small_rr", a, c=26)
    assert fr.array_to_ints(got) == [oracle.mul(oracle.P - 1, 26)] * 8
    assert torch.equal(got, fr.mul_small(a, 26))


@pytest.mark.parametrize("widths", [range(0, 12), range(12, 23), range(23, 34)],
                         ids=["0-11", "12-22", "23-33"])
def test_sponge_kernel_under_each_lane_count(widths, cuda_device):
    """Every G at batches 1, G - 1, G + 1, 31, 33 and 130 (not a multiple
    of the block), widths 0-33: one plain sponge per width over them all."""
    rng = np.random.default_rng(250 + widths[0])
    sizes = sorted({1, 31, 33, 130} | {g + d for g in poseidon_cuda.LANES
                                       for d in (-1, 1) if g + d > 0})
    for width in widths:
        g = digits(rng, (sum(sizes), width), cuda_device)
        if width:
            g[::5, width - 1, 0] += 1 << 16
        want = poseidon.hash_multiple(g) if width else fr.zeros(
            (sum(sizes),), device=cuda_device)
        x = fr.digits_to_limbs(g).contiguous()
        for lanes in poseidon_cuda.LANES:
            o = 0
            for size in sizes:
                got = poseidon_cuda.sponge_limbs(x[o:o + size], 3, lanes=lanes)
                assert torch.equal(fr.limbs_to_digits(got), want[o:o + size]), (
                    width, lanes, size)
                o += size


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("arity", [2, 3, 4, 8])
def test_verify_kernel_under_each_lane_count(lanes, arity, cuda_device):
    rng = np.random.default_rng(260 + arity)
    levels = merkle.build_tree_levels(digits(rng, (70,), cuda_device), arity)
    idx = torch.as_tensor(np.arange(133) * 5 % 70, device=cuda_device)
    pos, sib = merkle.generate_proofs(levels, arity, idx)
    leaves = levels[0][idx].clone()
    pos = pos.to(torch.int64)
    pos[::9, 0] = arity + 3  # out of range, both sides
    pos[4::10, -1] = -2
    leaves[2::7, 1] ^= 1
    root = levels[-1][0]
    want = merkle._verify_plain(pos, sib, leaves, root, arity)
    for k in sorted({1, max(lanes - 1, 1), lanes + 1, 31, 33, 133}):
        got = poseidon_cuda.verify_digits(pos[:k], sib[:k], leaves[:k], root,
                                          arity, lanes=lanes)
        assert torch.equal(got, want[:k]), k
    assert want.any() and not want.all()


def test_tree_method_on_card_proofs_is_one_verify_launch(cuda_device,
                                                         monkeypatch):
    rng = np.random.default_rng(270)
    tree = merkle.NaryMerkleTree(digits(rng, (300,), cuda_device),
                                 merkle.MerkleConfig(4))
    idx = torch.as_tensor(np.arange(200) % 300, device=cuda_device)
    pos, sib = tree.generate_batch_proofs(idx)
    proved = tree.levels[0][idx]
    monkeypatch.setattr(merkle, "_host",
                        lambda x: pytest.fail("host copy of card proofs"))
    poseidon_cuda.reset_launch_counts()
    assert tree.verify_batch_proofs(pos, sib, proved)
    assert poseidon_cuda.launch_counts["verify"] == 1
    assert poseidon_cuda.launch_counts["sponge"] == 0
    bad = proved.clone()
    bad[17, 0] ^= 1
    assert not tree.verify_batch_proofs(pos, sib, bad)


@pytest.mark.parametrize("width", [0, 1, 2, 3, 5, 9, 16, 33])
def test_sponge_kernel_matches_plain(width, cuda_device):
    rng = np.random.default_rng(200 + width)
    g = digits(rng, (256, width), cuda_device)
    if width:
        g[3, 0, 1] += 1 << 16  # non-canonical digit: counts by value
    got = poseidon_cuda.hash_multiple_cuda(g)
    assert torch.equal(got, poseidon.hash_multiple(g))
    row = fr.array_to_ints(g[3])
    assert fr.array_to_ints(got[3])[0] == oracle.hash_multiple(
        [v & ((1 << 256) - 1) for v in row])


@pytest.mark.parametrize("n,arity", [(16, 2), (17, 3), (17, 4), (16, 8)])
def test_tree_and_verify_kernels_match_plain(n, arity, cuda_device):
    rng = np.random.default_rng(300 + n)
    leaves = digits(rng, (n,), cuda_device)
    levels = merkle.build_tree_levels(leaves, arity)
    plain = merkle.build_tree_levels(leaves.cpu(), arity)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(levels, plain))
    idx = [0, 1, n // 2, n - 1]
    pos, sib = merkle.generate_proofs(levels, arity, idx)
    proved = levels[0][idx].clone()
    pos[3, 0] = arity + 1  # out of range: the current node is dropped
    sib[2, 0, 0, 0] += 1 << 16
    proved[1, 0] ^= 1
    got = merkle.verify_proofs(pos, sib, proved, levels[-1][0], arity)
    want = merkle._verify_plain(pos, sib, proved, levels[-1][0], arity)
    assert torch.equal(got, want)
    assert got.tolist() == [True, False, False, False]


def test_verify_digits_rejects_bad_lanes_and_heights(cuda_device):
    def zeros(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=cuda_device)

    leaves, root = zeros(4, 16), zeros(16)
    with pytest.raises(errors.ValidationError, match="lanes"):
        poseidon_cuda.verify_digits(zeros(4, 1, dtype=torch.int32),
                                    zeros(4, 1, 1, 16), leaves, root, 2, lanes=2)
    with pytest.raises(errors.ValidationError, match="disagree"):
        poseidon_cuda.verify_digits(zeros(4, 0, dtype=torch.int32),
                                    zeros(4, 0, 1, 16), leaves, root, 2)


def test_verify_digits_rejects_bad_arity_and_shapes(cuda_device):
    def zeros(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=cuda_device)

    pos, leaves, root = zeros(4, 1, dtype=torch.int32), zeros(4, 16), zeros(16)
    with pytest.raises(errors.ValidationError, match="arity"):
        poseidon_cuda.verify_digits(pos, zeros(4, 1, 0, 16), leaves, root, 1)
    with pytest.raises(errors.ValidationError, match="disagree"):
        poseidon_cuda.verify_digits(pos, zeros(4, 1, 1, 16), leaves, root, 3)
    with pytest.raises(errors.ValidationError, match="int64 digits"):
        poseidon_cuda.verify_digits(pos, zeros(4, 1, 1, 8, dtype=torch.int32),
                                    leaves, root, 2)
    with pytest.raises(errors.ValidationError, match="CUDA tensor"):
        poseidon_cuda.verify_digits(pos, zeros(4, 1, 1, 16), leaves, root.cpu(), 2)


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("arity,n_leaves", [(4, 65_536), (8, 300_000)])
def test_verify_digits_equals_the_plain_verify_on_5000_proofs(
        arity, n_leaves, lanes, cuda_device):
    """K3 against the plain verify on 5,000 proofs at 8 levels (arity 4)
    and 7 levels (arity 8): tampered leaves, a sibling digit d + 2^16, one
    2^32 + d, a leaf's top digit at 2^40 - 1 and positions out of range, at
    batches below and above a block and the whole."""
    rng = np.random.default_rng(530 + arity)
    levels = merkle.build_tree_levels(digits(rng, (n_leaves,), cuda_device),
                                      arity)
    idx = torch.as_tensor(rng.integers(0, n_leaves, 5_000), device=cuda_device)
    pos, sib = merkle.generate_proofs(levels, arity, idx)
    assert pos.shape == (5_000, 8 if arity == 4 else 7)
    leaves = levels[0][idx].clone()
    root = levels[-1][0]
    leaves[::97, 3] ^= 1
    sib[1::89, 2, 0, 4] += 1 << 16
    sib[2::83, 0, 1, 2] += 1 << 32
    leaves[3::79, 15] = (1 << 40) - 1
    pos[4::71, 1] = arity + 5
    pos[5::73, 6] = -7
    want = merkle._verify_plain(pos, sib, leaves, root, arity)
    assert want.any() and not want.all()
    for k in (1, 33, 130, 5_000):
        got = poseidon_cuda.verify_digits(pos[:k], sib[:k], leaves[:k], root,
                                          arity, lanes=lanes)
        assert got.dtype == torch.bool
        assert torch.equal(got, want[:k]), k


def test_permutation_kernel_matches_plain_and_oracle(cuda_device):
    rng = np.random.default_rng(400)
    edges = [0, 1, oracle.P - 1, oracle.P, (1 << 256) - 1]
    combos = [(a, b, c) for a in edges for b in edges for c in edges]
    edge_states = fr.ints_to_array(
        [v for c in combos for v in c], device=cuda_device
    ).reshape(len(combos), 3, 16)
    odd = digits(rng, (2, 3), cuda_device)
    odd[0, 1, 5] += 1 << 16
    odd[1, 0, 0] = 0xFFFFFFFF
    states = torch.cat([digits(rng, (1024, 3), cuda_device), edge_states, odd])
    got = poseidon_cuda.permutation_cuda(states)
    assert torch.equal(got, poseidon.permutation(states))
    top = (1 << 256) - 1
    for i in (1024, 1024 + len(combos) - 1, states.shape[0] - 2,
              states.shape[0] - 1):
        want = oracle.permutation([v & top for v in fr.array_to_ints(states[i])])
        assert fr.array_to_ints(got[i]) == want


@pytest.mark.parametrize("width", [0, 2, 5])
def test_packed_entry_points_match_unpacked(width, cuda_device):
    rng = np.random.default_rng(500 + width)
    x, y = digits(rng, (1024,), cuda_device), digits(rng, (1024,), cuda_device)
    assert torch.equal(poseidon_cuda.hash_single_cuda_packed(fr.pack16(x)),
                       poseidon_cuda.hash_single_cuda(x))
    assert torch.equal(
        poseidon_cuda.hash_pair_cuda_packed(fr.pack16(x), fr.pack16(y)),
        poseidon_cuda.hash_pair_cuda(x, y))
    g = digits(rng, (1024, width), cuda_device)
    assert torch.equal(poseidon_cuda.hash_multiple_cuda_packed(fr.pack16(g)),
                       poseidon_cuda.hash_multiple_cuda(g))


def test_coalescing_over_cuda_matches_direct(cuda_device):
    from cuzk_tpu_torch import engine

    rng = np.random.default_rng(600)
    direct = engine.CudaPoseidonEngine(cuda_device)
    ce = engine.CoalescingPoseidonEngine(engine.CudaPoseidonEngine(cuda_device))
    calls = []
    for n in (1, 300, 700):
        x = rng.integers(0, 1 << 16, (n, 16), np.uint32)
        calls.append((ce.async_hash_single(x), direct.batch_hash_single(x)))
        g = rng.integers(0, 1 << 16, (n, 5, 16), np.uint32)
        calls.append((ce.async_hash_multiple(g), direct.batch_hash_multiple(g)))
    x = rng.integers(0, 1 << 16, (64, 16), np.uint32)
    y = x.copy()
    y[5, 9] = (1 << 16) + 3  # non-canonical: the flush goes full width
    calls.append((ce.async_hash_pairs(x, y), direct.batch_hash_pairs(x, y)))
    for d, want in calls:
        assert torch.equal(d.get(), want)
    st = rng.integers(0, 1 << 16, (64, 3, 16), np.uint32)
    assert torch.equal(ce.batch_permutation(st), poseidon.permutation(
        torch.as_tensor(st.astype(np.int64), device=cuda_device)))


def test_device_loops_match_repeated_hashing(cuda_device):
    rng = np.random.default_rng(700)
    x, y = digits(rng, (512,), cuda_device), digits(rng, (512,), cuda_device)
    want_pair, want_single = x, x
    for _ in range(3):
        want_pair = poseidon_cuda.hash_pair_cuda(want_pair, y)
        want_single = poseidon_cuda.hash_single_cuda(want_single)
    assert torch.equal(poseidon_cuda.hash_pair_cuda_loop(x, y, 3), want_pair)
    assert torch.equal(poseidon_cuda.hash_single_cuda_loop(x, 3), want_single)


def test_optimal_batch_size_fills_every_sm(cuda_device):
    from cuzk_tpu_torch import engine

    e = engine.CudaPoseidonEngine(cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    size = e.get_optimal_batch_size()
    assert size > 0 and size % sms == 0
    assert engine.verify_engines_match(batch=256, device=cuda_device)


def _host_batch(rng, n, arity, idx, device):
    leaves = digits(rng, (n,), device)
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    pos, sib = tree.generate_batch_proofs(idx)
    return (pos.cpu().numpy(), sib.cpu().numpy().astype(np.uint32),
            tree.levels[0][idx].cpu().numpy().astype(np.uint32),
            tree.get_root_hash().cpu().numpy().astype(np.uint32))


@pytest.mark.parametrize("tamper", [False, True])
def test_dedup_device_program_matches_plain(tamper, cuda_device):
    rng = np.random.default_rng(800)
    pos, sib, lv, root = _host_batch(rng, 256, 4, np.arange(600) % 256,
                                     cuda_device)
    if tamper:
        lv[17, 3] ^= 1
    wire = merkle._dedup_pack(pos, sib, lv, root, 4)
    got = merkle._dedup_verify_levels(
        4, wire.sizes, wire.kb, wire.tb, wire.lm16,
        merkle._upload(wire.packed, cuda_device))
    want = merkle._dedup_verify_levels(
        4, wire.sizes, wire.kb, wire.tb, wire.lm16,
        merkle._upload(wire.packed, torch.device("cpu")))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert want[0].tolist() == [not tamper, True]


@pytest.mark.parametrize("arity", [2, 4, 8])
def test_verify_each_on_the_card_matches_the_verify_kernel(arity, cuda_device):
    rng = np.random.default_rng(810 + arity)
    idx = np.arange(300) % 97
    pos, sib, lv, root = _host_batch(rng, 97, arity, idx, cuda_device)

    def k3(p, s, l, r):
        return merkle.verify_proofs(
            torch.as_tensor(p, device=cuda_device),
            fr.as_digits(s, device=cuda_device),
            fr.as_digits(l, device=cuda_device),
            fr.as_digits(r, device=cuda_device), arity).cpu().numpy()

    got = merkle.verify_each(pos, sib, lv, root, arity, device=cuda_device)
    assert got.all() and np.array_equal(got, k3(pos, sib, lv, root))
    lv2, sib2, pos2 = lv.copy(), sib.copy(), pos.copy()
    lv2[5, 0] ^= 1
    sib2[50, 1, 0, 3] ^= 1
    pos2[99, 0] = (pos2[99, 0] + 1) % arity
    got = merkle.verify_each(pos2, sib2, lv2, root, arity, device=cuda_device)
    assert np.flatnonzero(~got).tolist() == [5, 50, 99]
    assert np.array_equal(got, k3(pos2, sib2, lv2, root))
    sib2[7, 0, 0, 0] += 1 << 16  # declined: the exact path decides
    assert merkle._dedup_pack(pos2, sib2, lv2, root, arity) is None
    got = merkle.verify_each(pos2, sib2, lv2, root, arity, device=cuda_device)
    assert np.array_equal(got, k3(pos2, sib2, lv2, root))
    assert np.flatnonzero(~got).tolist() == [5, 7, 50, 99]


def test_out_of_range_positions_through_the_verify_kernel(cuda_device):
    rng = np.random.default_rng(820)
    leaves = digits(rng, (64,), cuda_device)
    levels = merkle.build_tree_levels(leaves, 4)
    pos, sib = merkle.generate_proofs(levels, 4, [0, 5, 9, 63])
    pos = pos.to(torch.int64)
    pos[0, 0] = -1
    pos[1, 1] = -(1 << 40)
    pos[2, 2] = (1 << 32) + int(pos[2, 2])  # int32 would alias the valid one
    got = merkle.verify_proofs(pos, sib, levels[0][[0, 5, 9, 63]],
                               levels[-1][0], 4)
    want = merkle.verify_proofs(pos.cpu(), sib.cpu(),
                                levels[0][[0, 5, 9, 63]].cpu(),
                                levels[-1][0].cpu(), 4)
    assert torch.equal(got.cpu(), want)
    assert want.tolist() == [False, False, False, True]
    # The digit form on int32 positions as they are: the kernel clamps.
    pos32 = pos.clamp(-8, 8).to(torch.int32)
    pos32[0, 0], pos32[1, 1] = -7, 5
    want32 = merkle._verify_plain(pos32.cpu(), sib.cpu(),
                                  levels[0][[0, 5, 9, 63]].cpu(),
                                  levels[-1][0].cpu(), 4)
    for lanes in poseidon_cuda.LANES:
        got32 = poseidon_cuda.verify_digits(
            pos32, sib, levels[0][[0, 5, 9, 63]], levels[-1][0], 4, lanes=lanes)
        assert torch.equal(got32.cpu(), want32)
    assert want32.tolist() == [False, False, False, True]


def test_updates_batch_trees_and_load_on_the_card(cuda_device, tmp_path):
    rng = np.random.default_rng(830)
    leaves = digits(rng, (100,), cuda_device)
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(4))
    vals = digits(rng, (5,), cuda_device)
    idx = [0, 3, 50, 98, 99]
    assert tree.update_leaves(idx, vals) and tree.insert_leaf(vals[0])
    new = leaves.clone().cpu()
    new[idx] = vals.cpu()
    want = merkle.build_tree_levels(torch.cat([new, vals[:1].cpu()]), 4)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(tree.levels, want))
    sets = [digits(rng, (70,), cuda_device) for _ in range(3)]
    for t, s in zip(merkle.build_batch_trees(sets, 4), sets):
        assert torch.equal(t.get_root_hash().cpu(),
                           merkle.merkle_root(s.cpu(), 4))
    path = str(tmp_path / "t.npz")
    merkle.save_tree(tree, path)
    loaded = merkle.load_tree(path, verify=True, device=cuda_device)
    assert loaded.levels[0].is_cuda and merkle.compare_trees(tree, loaded)


@pytest.mark.parametrize("arity,count", [(8, 5000), (4, 1024), (3, 5)])
def test_one_rank_sharded_build_and_proofs_on_the_card(arity, count,
                                                       cuda_device):
    """The one-rank mesh needs no launcher: host leaves go to the card, the
    levels come from K1 and the proofs verify through one K3 launch."""
    from cuzk_tpu_torch.parallel import distributed

    rng = np.random.default_rng(900 + arity)
    leaves = rng.integers(0, 1 << 16, (count, 16), dtype=np.uint32)
    mesh = distributed.make_mesh()
    assert mesh.device == cuda_device and mesh.size == 1
    want = merkle.build_tree_levels(leaves, arity)
    poseidon_cuda.reset_launch_counts()
    sharded, replicated = distributed.sharded_build_levels(leaves, arity, mesh)
    assert poseidon_cuda.launch_counts["sponge"] == len(want) - 1
    got = sharded[:-1] + replicated
    assert len(got) == len(want) and got[0].is_cuda
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    idx = rng.integers(0, count, 200)
    pos, sib = distributed.sharded_generate_proofs(sharded, replicated, arity,
                                                   idx, mesh)
    want_pos, want_sib = merkle.generate_proofs(want, arity, idx)
    assert torch.equal(pos, want_pos) and torch.equal(sib, want_sib)
    root = distributed.sharded_merkle_root(leaves, arity, mesh)
    poseidon_cuda.reset_launch_counts()
    ok = merkle.verify_proofs(pos, sib, want[0][torch.as_tensor(idx)], root,
                              arity)
    assert bool(ok.all()) and poseidon_cuda.launch_counts["verify"] == 1


def test_sharded_hashes_on_the_card(cuda_device):
    from cuzk_tpu_torch.parallel import distributed

    rng = np.random.default_rng(910)
    l, r = (rng.integers(0, 1 << 16, (4096, 16), dtype=np.uint32)
            for _ in range(2))
    mesh = distributed.make_mesh()
    pairs = distributed.sharded_hash_pairs(l, r, mesh)
    assert pairs.is_cuda
    assert torch.equal(pairs.cpu(), poseidon.hash_pair(
        fr.as_digits(l), fr.as_digits(r)))
    single = distributed.sharded_hash_single(l, mesh)
    assert torch.equal(single.cpu(), poseidon.hash_single(fr.as_digits(l)))


@pytest.mark.parametrize("nproc", [1, 2])
def test_launcher_ranks_on_the_card(nproc, cuda_device):
    """Spawned ranks on the card: NCCL for one rank, gloo through the host
    for two that share it; the root is the single-card build's."""
    from cuzk_tpu_torch.bench import mp_scaling
    from cuzk_tpu_torch.parallel import distributed

    res = mp_scaling.run_build(nproc, 4096 * nproc, 8, 1, timeout_s=600)
    assert res["backend"] == distributed.choose_backend(nproc)
    assert res["shared_card"] == (nproc > torch.cuda.device_count())
    assert res["sponge_launches_per_build"] == 4 + (nproc == 2)
    leaves = np.random.default_rng(17).integers(
        0, 1 << 16, (4096 * nproc, 16), dtype=np.uint32)
    assert res["root0"] == int(merkle.merkle_root(leaves, 8)[0])


# ---------------------------------------------------------------------------
# Slice 6: the device sub, batch field ops, engine_path, the int helpers
# ---------------------------------------------------------------------------

def test_fr_op_sub_on_edge_operands(cuda_device):
    """Every pair of 0, 1, p - 1, p, p + 1, 2^256 - 1 and two random values:
    a < b (p pre-added), a == b, operands >= p (no reduce)."""
    from cuzk_tpu_torch import oracle as port_oracle

    vals = [0, 1, oracle.P - 1, oracle.P, oracle.P + 1, (1 << 256) - 1,
            0x1234 << 200, oracle.P >> 1]
    pairs = [(x, y) for x in vals for y in vals]
    a = fr.ints_to_array([x for x, _ in pairs], device=cuda_device)
    b = fr.ints_to_array([y for _, y in pairs], device=cuda_device)
    got = poseidon_cuda.fr_op_cuda("sub", a, b)
    assert torch.equal(got, fr.sub(a, b))
    assert fr.array_to_ints(got) == [port_oracle.sub(x, y) for x, y in pairs]
    with pytest.raises(errors.ValidationError):
        poseidon_cuda.fr_op_cuda("sub", a)
    with pytest.raises(errors.ValidationError):
        poseidon_cuda.fr_op_cuda("square", a, b)


def test_batch_field_arithmetic_on_the_card(cuda_device):
    from cuzk_tpu_torch.field.batch import BatchFieldArithmetic

    rng = np.random.default_rng(61)
    a, b = digits(rng, (4099,), cuda_device), digits(rng, (4099,), cuda_device)
    ops = BatchFieldArithmetic()
    assert ops.initialize()
    before = dict(poseidon_cuda.launch_counts)
    for method, plain, args in [
        ("batch_add", fr.add, (a, b)), ("batch_subtract", fr.sub, (a, b)),
        ("batch_multiply", fr.mul, (a, b)), ("batch_square", fr.square, (a,)),
        ("batch_power5", fr.power5, (a,)), ("batch_reduce", fr.red, (a,)),
    ]:
        got = getattr(ops, method)(*args)
        assert got.is_cuda and torch.equal(got, plain(*args)), method
    assert poseidon_cuda.launch_counts["fr_op"] - before["fr_op"] == 6
    assert ops.stats.total_hashes == 6 * 4099
    host = ops.batch_subtract(a.cpu().numpy(), b.cpu().numpy())
    assert host.is_cuda and torch.equal(host, fr.sub(a, b))
    three_d = ops.batch_multiply(a.view(-1, 1, 16), b[:1])  # broadcasts
    assert torch.equal(three_d, fr.mul(a.view(-1, 1, 16), b[:1]))


def test_engine_path_plain_on_card_tensors(cuda_device):
    """engine_path("plain") runs the plain sponge and verify on the card,
    launching no kernel, and gives the kernel route's digits."""
    rng = np.random.default_rng(62)
    leaves = digits(rng, (300,), cuda_device)
    levels = merkle.build_tree_levels(leaves, 4)
    idx = torch.arange(0, 300, 7, device=cuda_device)
    pos, sib = merkle.generate_proofs(levels, 4, idx)
    proved = levels[0][idx].clone()
    proved[3, 0] ^= 1
    vals = digits(rng, (5,), cuda_device)
    uidx = [1, 50, 99, 200, 299]
    want_up = merkle.update_tree_levels(levels, 4, uidx, vals)
    want_ok = merkle.verify_proofs(pos, sib, proved, levels[-1][0], 4)
    poseidon_cuda.reset_launch_counts()
    with merkle.engine_path("plain"):
        plain = merkle.build_tree_levels(leaves, 4)
        up = merkle.update_tree_levels(plain, 4, uidx, vals)
        ok = merkle.verify_proofs(pos, sib, proved, levels[-1][0], 4)
    assert set(poseidon_cuda.launch_counts.values()) == {0}
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(plain, levels))
    assert all(torch.equal(a, b) for a, b in zip(up, want_up))
    assert torch.equal(ok, want_ok) and not bool(ok[3])
    with merkle.engine_path("kernel"):
        forced = merkle.build_tree_levels(leaves, 4)
    assert all(torch.equal(a, b) for a, b in zip(forced, levels))
    assert poseidon_cuda.launch_counts["sponge"] == len(levels) - 1


def test_int_helpers_on_the_card(cuda_device):
    from cuzk_tpu_torch import oracle as port_oracle

    assert poseidon.hash_single_int(42) == port_oracle.hash_single(42)
    assert poseidon.hash_pair_int(10, 20) == \
        0x2DD359F92D31C747E06C02B360A9F5C761777B285EDCF09724EFEF5CBD51D9BA
    assert poseidon.hash_multiple_int(range(1, 10)) == \
        port_oracle.hash_multiple(list(range(1, 10)))
    assert poseidon.hash_multiple_int([]) == 0


# ---------------------------------------------------------------------------
# K4's redesign and the digit forms of K4 and the per-op check kernel
# ---------------------------------------------------------------------------

def _edge_and_odd_states(rng, device):
    edges = [0, 1, oracle.P - 1, oracle.P, (1 << 256) - 1]
    combos = [(a, b, c) for a in edges for b in edges for c in edges]
    edge_states = fr.ints_to_array(
        [v for c in combos for v in c], device=device).reshape(len(combos), 3, 16)
    odd = digits(rng, (3, 3), device)
    odd[0, 1, 5] += 1 << 16
    odd[1, 0, 0] = 0xFFFFFFFF
    odd[2, 2, 15] = (1 << 40) - 1
    return torch.cat([edge_states, odd])


def test_permutation_on_edge_rows_and_non_canonical_digits(cuda_device):
    """K4 (permutation_cuda) on the edge rows and non-canonical digits, and
    on an offset view, against the plain permutation."""
    rng = np.random.default_rng(401)
    states = torch.cat([digits(rng, (517, 3), cuda_device),
                        _edge_and_odd_states(rng, cuda_device)])
    want = poseidon.permutation(states)
    got = poseidon_cuda.permutation_cuda(states)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert torch.equal(poseidon_cuda.permutation_cuda(states[1:]), want[1:])  # an offset view


@pytest.mark.parametrize("batch", [4096, 16384, 65536, 262144, 1048576])
def test_permutation_kernel_exact_at_the_sweep_shapes(batch, cuda_device):
    """K4 at each shape of chip_smoke.py's sweep, held against the plain
    permutation on 512 rows spread over the batch."""
    rng = np.random.default_rng(batch)
    states = digits(rng, (batch, 3), cuda_device)
    rows = torch.as_tensor(np.linspace(0, batch - 1, 512).astype(np.int64),
                           device=cuda_device)
    want = poseidon.permutation(states[rows])
    got = poseidon_cuda.permutation_cuda(states)
    assert torch.equal(got[rows], want)


@pytest.mark.parametrize("op", sorted(poseidon_cuda.FR_OPS))
def test_fr_op_on_non_canonical_rows(op, cuda_device):
    """The check kernel (fr_op_cuda) on random, edge and non-canonical rows
    (d + 2^16, 2^40 - 1, read by value), against the plain op on the
    canonical digits of the same values (fr.carry)."""
    rng = np.random.default_rng(402)
    edges = fr.ints_to_array([0, 1, oracle.P - 1, oracle.P, (1 << 256) - 1],
                             device=cuda_device)
    a = torch.cat([digits(rng, (1000,), cuda_device), edges])
    b = torch.cat([digits(rng, (1000,), cuda_device), edges.flip(0)])
    a[0, 3] += 1 << 16
    a[1, 15] = (1 << 40) - 1
    b[2, 0] += 1 << 16
    if op in ("add_rr", "mul_small_rr"):
        a, b = fr.red(fr.carry(a)), fr.red(fr.carry(b))
    c = 26 if op.startswith("mul_small") else 0
    plain = poseidon_cuda.FR_OPS[op][1]
    ca, cb = fr.carry(a), fr.carry(b)
    if op == "reduce_wide":
        x, want = (torch.cat([a, b], dim=1),), plain(torch.cat([ca, cb], dim=1))
    elif op in ("mul_small", "mul_small_rr"):
        x, want = (a,), plain(ca, c)
    elif op in ("mul", "add_wrap_red", "add_rr", "sub"):
        x, want = (a, b), plain(ca, cb)
    else:
        x, want = (a,), plain(ca)
    got = poseidon_cuda.fr_op_cuda(op, *x, c=c)
    assert got.dtype == torch.int64 and torch.equal(got, want)


def test_digit_forms_take_rows_off_16_bytes(cuda_device):
    """A contiguous digit view whose rows start 8 bytes off a 16-byte
    boundary: the wrappers copy it before the 16-byte row moves."""
    rng = np.random.default_rng(403)
    a, b = digits(rng, (33,), cuda_device), digits(rng, (33,), cuda_device)
    flat = torch.empty(33 * 16 + 1, dtype=torch.int64, device=cuda_device)
    off = flat[1:].view(33, 16)
    off.copy_(a)
    assert off.data_ptr() % 16 == 8
    assert torch.equal(poseidon_cuda.fr_op_cuda("sub", off, b), fr.sub(a, b))
    st = torch.empty(11 * 48 + 1, dtype=torch.int64, device=cuda_device)[1:]
    st = st.view(11, 3, 16)
    st.copy_(digits(rng, (11, 3), cuda_device))
    assert torch.equal(poseidon_cuda.permutation_cuda(st), poseidon.permutation(st))


def test_traced_build_and_verify_count_their_launches(cuda_device):
    """Under a profiler session the port's spans and launch counts read one
    K1 launch and one ``cuzk.k1`` span a level of a 65,536-leaf arity-4
    build (8), and one K3 launch, on the proofs' digits, for a 5,000-proof
    verify of card proofs."""
    from torch.profiler import ProfilerActivity, profile

    from cuzk_tpu_torch.utils import trace

    rng = np.random.default_rng(509)
    leaves = digits(rng, (65_536,), cuda_device)
    levels = merkle.build_tree_levels(leaves, 4)
    idx = torch.as_tensor(rng.integers(0, 65_536, 5_000), device=cuda_device)
    pos, sib = merkle.generate_proofs(levels, 4, idx)
    merkle.verify_each(pos, sib, leaves[idx], levels[-1][0], 4)  # warm
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    with profile(activities=activities):
        merkle.build_tree_levels(leaves, 4)
        torch.cuda.synchronize()
    t = trace.totals()
    assert t["requests"] == 1
    assert t["counters"]["launch.sponge"] == 8
    assert sum(r["count"] for r in t["spans"] if r["name"] == "cuzk.k1") == 8

    with profile(activities=activities):
        ok = merkle.verify_each(pos, sib, leaves[idx], levels[-1][0], 4)
    assert ok.all()
    t = trace.totals()
    assert t["requests"] == 1
    assert t["counters"]["launch.verify"] == 1
    assert t["counters"]["launch.sponge"] == 0
    assert t["counters"]["verify.route.card"] == 1
    # K3 reads the proofs' digits, at G = 1: nothing is converted to limbs.
    assert t["counters"]["k3.lanes.1"] == 1
    assert "convert.rows.to_limbs" not in t["counters"]
    assert t["wait_s"] > 0


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("arity", [2, 4, 8])
def test_sponge_digits_equals_the_conversion_then_sponge_limbs(arity, lanes,
                                                               cuda_device):
    """K1's digit form against ``fr.digits_to_limbs`` then K1's limb form,
    bit for bit, at batches below and above a block and one of 65,536
    rows, with digits d + 2^16 and 2^32 + d and a top digit of 2^40 - 1
    read by value."""
    rng = np.random.default_rng(520 + arity)
    g = digits(rng, (65_536, arity), cuda_device)
    g[::7, arity - 1, 3] += 1 << 16
    g[1::11, 0, 0] += 1 << 32
    g[2::13, arity - 1, 15] = (1 << 40) - 1
    want = poseidon_cuda.sponge_limbs(fr.digits_to_limbs(g).contiguous(), 3,
                                      lanes=lanes)
    for k in (1, 31, 130, 65_536):
        got = poseidon_cuda.sponge_digits(g[:k], 3, lanes=lanes)
        assert torch.equal(got, want[:k]), k
    assert torch.equal(fr.limbs_to_digits(want[:256]),
                       poseidon.hash_multiple(g[:256]))


def test_sector_base_trees_build_on_the_card(cuda_device):
    """The sector configuration's share of a card (zkbench/configs/
    filecoin-32g-rlast.json: two base trees of 8^9 = 2^27 leaves at arity 8,
    34.4 GB of digits) side by side, one K1 launch a level over both: at
    every level the first and last rows and 64 rows drawn from the seed
    equal the benchmark reference's hash of their 8 children.  Level 1's
    last row reads digits 2^32 - 128 .. 2^32 - 1 of its launch's input,
    past any 32-bit index.  Then the second tree alone through
    ``build_tree_levels`` gives the same levels; its peak memory is
    printed."""
    from zkbench.reference import field as ref_field
    from zkbench.reference.poseidon import Poseidon

    arity, n, trees = 8, 8 ** 9, 2
    gen = torch.Generator(device=cuda_device).manual_seed(3_300_000_015)
    leaves = torch.randint(0, 1 << 16, (trees * n, 16), generator=gen,
                           device=cuda_device, dtype=torch.int64)
    leaves[:, 15] &= 0x2FFF  # canonical: below p's top digit 0x3064
    assert leaves.numel() == 1 << 32
    levels = merkle._build_levels(leaves, arity, trees=trees)
    assert [lv.shape[0] for lv in levels] == [trees * 8 ** (9 - i)
                                              for i in range(10)]
    ref = Poseidon(ref_field.Field(cuda_device))
    rng = np.random.default_rng(521)
    for level in range(1, 10):
        m = levels[level].shape[0]
        rows = np.unique(np.concatenate([[0, m - 1], rng.integers(0, m, 64)]))
        rows_t = torch.as_tensor(rows, device=cuda_device)
        cols = rows_t[:, None] * arity + torch.arange(arity, device=cuda_device)
        want = ref.hash_multiple(levels[level - 1][cols])
        assert torch.equal(levels[level][rows_t], want), level
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    alone = merkle.build_tree_levels(leaves[n:], arity)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device)
    for level in range(10):
        assert torch.equal(alone[level], levels[level][levels[level].shape[0]
                                                      // trees:]), level
    print(f"\nsector base trees: peak {peak} bytes building one 2^27-leaf "
          f"tree beside {leaves.numel() * 8} bytes of leaves and both trees' "
          f"levels")
