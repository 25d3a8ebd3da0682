"""The work counts and the bound of ``roofline.py`` for both
configurations."""

import json
import os

import pytest

from zkbench import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(ROOT, "configs", name + ".json")) as fh:
        return json.load(fh)


def test_multiplies_per_permutation():
    assert roofline.LIMB_PRODUCTS_PER_PERMUTATION == 44_096
    assert roofline.MULTIPLIES_PER_PERMUTATION == 88_192


@pytest.mark.parametrize("name,perms,padded", [
    # 2^19 + ... + 1 binary nodes, one permutation each.
    ("semaphore-d20", 1_048_575, 1 << 20),
    # 16,384 + 4,096 + ... + 1 = 21,845 arity-4 nodes, two permutations each.
    ("cuzk-a4-50k", 43_690, 65_536),
])
def test_commit_permutations(name, perms, padded):
    cfg = config(name)
    assert roofline.padded_leaves(cfg["leaves"], cfg["arity"]) == padded
    assert roofline.commit_permutations(cfg["leaves"], cfg["arity"]) == perms


def test_verify_permutations():
    cfg = config("cuzk-a4-50k")
    assert cfg["levels"] == 8
    assert roofline.verify_permutations(5000, cfg["levels"], cfg["arity"]) == 80_000


def test_permutations_per_group():
    assert [roofline.permutations_per_group(a) for a in range(2, 9)] == \
        [1, 2, 2, 3, 3, 4, 4]


def test_bound_is_the_multiplies():
    perms = roofline.commit_permutations(1 << 20, 2)
    rows = (1 << 20) + (1 << 20) - 1
    assert roofline.bytes_bound_s(rows) < 0.05 * roofline.multiply_bound_s(perms)
    assert roofline.multiply_bound_s(1) == pytest.approx(
        88_192 / (132 * 64 * 1.98e9 * roofline.RESULTS_PER_SLOT))
