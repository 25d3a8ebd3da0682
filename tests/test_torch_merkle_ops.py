"""The port's tree operations against the JAX package, on the CPU.

Incremental updates and inserts give a full rebuild's levels (and the JAX
package's), leaving the input levels as they were; bad inputs are refused
as ``tests/test_merkle.py`` pins it for the JAX package.  Batch builds,
save/load (files cross-load both ways), the MerkleUtils helpers and
``utils.io`` agree with their JAX counterparts.  Inputs are numpy-seeded;
tolerance: none, every comparison is exact.
"""

import numpy as np
import pytest
import torch

from cuzk_tpu import merkle as jmerkle
from cuzk_tpu import oracle
from cuzk_tpu.field import fr as jfr
from cuzk_tpu.utils import io as jio
from cuzk_tpu_torch import merkle
from cuzk_tpu_torch.field import fr
from cuzk_tpu_torch.utils import errors, io

CPU = "cpu"  # the CPU tests ask for the plain path by name


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def leaves_np(n: int, seed: int) -> np.ndarray:
    d = np.random.default_rng(seed).integers(0, 1 << 16, (n, 16)).astype(np.uint32)
    d[:, 15] &= np.uint32(0x2FFF)
    return d


def t64(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64))


def assert_levels(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))


# ---------------------------------------------------------------------------
# Incremental updates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arity,n", [(2, 11), (4, 16), (8, 21)])
def test_update_leaves_match_rebuild_and_jax(arity, n):
    xs = leaves_np(n, 40 + n)
    tree = merkle.NaryMerkleTree(t64(xs), merkle.MerkleConfig(arity), device=CPU)
    before = [lv.clone() for lv in tree.levels]
    idxs = [0, n - 1, n // 2]  # includes the group at the padded boundary
    vals = leaves_np(3, 50 + n)
    new = merkle.update_tree_levels(tree.levels, arity, idxs, t64(vals))
    assert all(torch.equal(a, b) for a, b in zip(tree.levels, before))
    assert tree.update_leaves(idxs, t64(vals))
    xs2 = xs.copy()
    xs2[idxs] = vals
    assert_levels(tree.levels, merkle.build_tree_levels(t64(xs2), arity, device=CPU))
    assert_levels(new, tree.levels)
    jtree = jmerkle.NaryMerkleTree(xs, jmerkle.MerkleConfig(arity))
    assert jtree.update_leaves(idxs, vals)
    assert_levels(tree.levels, jtree.levels)


def test_update_leaf_and_insert_leaf_match_the_oracle():
    xs = leaves_np(4, 7)
    tree = merkle.NaryMerkleTree(t64(xs), device=CPU)
    new_val = leaves_np(1, 8)[0]
    assert tree.update_leaf(1, t64(new_val))
    xs2 = xs.copy()
    xs2[1] = new_val
    extra = leaves_np(1, 9)[0]
    assert tree.insert_leaf(t64(extra))  # 4 -> 5 leaves: capacity grows
    assert tree.get_leaf_count() == 5
    ints = jfr.array_to_ints(np.concatenate([xs2, extra[None]]))
    assert tree.root_int() == oracle.merkle_root(ints, 2)


@pytest.mark.parametrize("arity", [2, 4])
def test_insert_leaf_into_padded_slots_matches_rebuild(arity):
    """Inserts into free padded slots take the incremental path and equal a
    rebuild (and the JAX package); for arity 2 the fourth crosses the
    capacity and rebuilds."""
    xs = leaves_np(5, 60 + arity)
    tree = merkle.NaryMerkleTree(t64(xs), merkle.MerkleConfig(arity), device=CPU)
    jtree = jmerkle.NaryMerkleTree(xs, jmerkle.MerkleConfig(arity))
    for i, v in enumerate(leaves_np(4, 70 + arity)):
        assert tree.insert_leaf(t64(v)) and jtree.insert_leaf(v)
        xs = np.concatenate([xs, v[None]])
        assert tree.get_leaf_count() == len(xs) == jtree.get_leaf_count()
        assert_levels(tree.levels, merkle.build_tree_levels(t64(xs), arity, device=CPU))
        if i in (0, 3):
            assert_levels(tree.levels, jtree.levels)


def test_update_refuses_bad_inputs_and_keeps_the_tree():
    tree = merkle.NaryMerkleTree(t64(leaves_np(6, 80)), device=CPU)
    root_before = tree.root_int()
    v = t64(leaves_np(1, 81))
    assert not tree.update_leaves([1, 1], t64(leaves_np(2, 82)))  # duplicates
    assert not tree.update_leaves([6], v)  # past the leaf count
    assert not tree.update_leaves([-1], v)
    assert not tree.update_leaves([], torch.zeros((0, 16), dtype=torch.int64))
    assert not tree.update_leaves([0, 1, 2], v)  # one row for three indices
    with pytest.raises(errors.ValidationError):
        merkle.update_tree_levels(tree.levels, 2, [0, 1, 2], v)
    with pytest.raises(errors.ValidationError, match="unique"):
        merkle.update_tree_levels(tree.levels, 2, [3, 3], t64(leaves_np(2, 83)))
    with pytest.raises(errors.IndexError_, match="8"):
        merkle.update_tree_levels(tree.levels, 2, [8], v)  # 8 padded rows
    with pytest.raises(IndexError, match="-2"):
        merkle.update_tree_levels(tree.levels, 2, [-2], v)
    assert not merkle.NaryMerkleTree(device=CPU).update_leaves([0], v)
    assert tree.root_int() == root_before


# ---------------------------------------------------------------------------
# Batch builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(5, 5, 5), (2, 4)], ids=["equal", "mixed"])
def test_build_batch_trees_matches_jax(sizes):
    sets = [leaves_np(n, 90 + i) for i, n in enumerate(sizes)]
    trees = merkle.build_batch_trees([t64(s) for s in sets], arity=2, device=CPU)
    jtrees = jmerkle.build_batch_trees(sets, arity=2)
    assert len(trees) == len(sets)
    for s, t, jt in zip(sets, trees, jtrees):
        assert t.get_leaf_count() == len(s)
        assert_levels(t.levels, jt.levels)
        pos, sib = t.generate_batch_proofs([0, len(s) - 1])
        assert t.verify_batch_proofs(pos, sib, t.levels[0][[0, len(s) - 1]])
    assert merkle.build_batch_trees([], arity=2, device=CPU) == []


# ---------------------------------------------------------------------------
# Save and load
# ---------------------------------------------------------------------------

def test_trees_cross_load_between_the_packages(tmp_path):
    xs = leaves_np(10, 100)
    tree = merkle.NaryMerkleTree(t64(xs), merkle.MerkleConfig(4), device=CPU)
    port_file = str(tmp_path / "port.npz")
    merkle.save_tree(tree, port_file)
    jtree = jmerkle.load_tree(port_file, verify=True)
    assert jtree.config.arity == 4 and jtree.get_leaf_count() == 10
    assert_levels(tree.levels, jtree.levels)

    jax_file = str(tmp_path / "jax.npz")
    jmerkle.save_tree(jmerkle.NaryMerkleTree(xs, jmerkle.MerkleConfig(4)),
                      jax_file)
    loaded = merkle.load_tree(jax_file, verify=True, device="cpu")
    assert loaded.get_leaf_count() == 10 and loaded.config.arity == 4
    assert merkle.compare_trees(tree, loaded)
    assert_levels(loaded.levels, jtree.levels)
    pos, sib = loaded.generate_batch_proofs([0, 7, 9])
    assert loaded.verify_batch_proofs(pos, sib, loaded.levels[0][[0, 7, 9]])
    with pytest.raises(errors.ValidationError):
        merkle.save_tree(merkle.NaryMerkleTree(device=CPU), port_file)


def test_load_verify_catches_a_tampered_level(tmp_path):
    tree = merkle.NaryMerkleTree(t64(leaves_np(9, 110)), device=CPU)
    path = str(tmp_path / "tree.npz")
    merkle.save_tree(tree, path)
    assert merkle.load_tree(path, verify=True, device=CPU).root_int() == tree.root_int()
    with np.load(path) as data:
        payload = {k: data[k].copy() for k in data.files}
    payload["level_1"][0, 0] ^= 1  # intermediate level, root untouched
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, **payload)
    with pytest.raises(errors.ComputationError):
        merkle.load_tree(bad, verify=True, device=CPU)
    assert merkle.load_tree(bad, device=CPU).get_leaf_count() == 9  # trusted fast path


def test_save_refuses_digits_a_uint32_cast_would_alias(tmp_path):
    leaves = t64(leaves_np(4, 120))
    leaves[2, 3] += 1 << 32
    tree = merkle.NaryMerkleTree(leaves, device=CPU)
    with pytest.raises(errors.ValidationError, match="2\\^32"):
        merkle.save_tree(tree, str(tmp_path / "t.npz"))


# ---------------------------------------------------------------------------
# MerkleUtils parity and utils.io
# ---------------------------------------------------------------------------

def test_proof_structure_compare_and_print_match_jax(capsys):
    xs = leaves_np(4, 130)
    t1, t2 = merkle.NaryMerkleTree(t64(xs), device=CPU), merkle.NaryMerkleTree(t64(xs), device=CPU)
    t3 = merkle.NaryMerkleTree(t64(xs[:2]), device=CPU)
    assert merkle.compare_trees(t1, t2) and not merkle.compare_trees(t1, t3)
    assert not merkle.compare_trees(t1, merkle.NaryMerkleTree(device=CPU))
    pos, sib = t1.generate_batch_proofs([1])
    assert merkle.validate_proof_structure(pos[0], sib[0], 2)
    assert not merkle.validate_proof_structure(pos[0], sib[0], 3)
    bad = pos[0].clone()
    bad[0] = 2
    assert not merkle.validate_proof_structure(bad, sib[0], 2)
    jt = jmerkle.NaryMerkleTree(xs)
    assert merkle.print_tree(t1) == jmerkle.print_tree(jt)
    assert merkle.print_tree(merkle.NaryMerkleTree(device=CPU)) == "(empty tree)"
    assert "root" in capsys.readouterr().out


def test_benchmark_tree_fills_the_result():
    r = merkle.benchmark_tree(64, 4, num_proofs=8, device=CPU)
    assert (r.leaf_count, r.arity) == (64, 4)
    assert r.tree_height == merkle.tree_height(64, 4) == 4
    assert r.build_time_ms > 0 and r.proof_time_ms > 0 and r.verify_time_ms > 0


def test_io_matches_jax():
    x = (1 << 255) + 12345
    assert io.to_hex(x) == jio.to_hex(x)
    d = io.from_hex(jio.to_hex(x))
    assert d.tolist() == jio.from_hex(jio.to_hex(x)).tolist()
    assert io.to_hex(d) == jio.to_hex(jio.from_hex(hex(x)))
    assert io.to_decimal(d) == jio.to_decimal(x) == str(x)
    assert io.from_decimal(str(x)).tolist() == jio.from_decimal(str(x)).tolist()
    with pytest.raises(ValueError):
        io.from_hex("1" + "0" * 64)
    for seed in (None, 7):
        assert io.random_elements(5, seed).tolist() == \
            jio.random_elements(5, seed).tolist()
    assert io.random_element(3).tolist() == jio.random_element(3).tolist()
    assert io.random_elements(0).shape == (0, fr.NDIGITS)
