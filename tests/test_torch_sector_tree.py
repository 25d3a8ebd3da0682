"""The sector configuration's shape (``zkbench/configs/filecoin-32g-rlast.json``:
base trees at arity 8, two side by side on a card) at 8^3 leaves a tree on
the CPU: the port's plain build of two seeded trees side by side
(``merkle.build_batch_trees``, one level loop over both) equals the
benchmark's plain reference (``zkbench/reference/merkle.py``, which imports
nothing of the port) level by level.  The card runs the same shape at 8^9
leaves (``tests/test_torch_cuda.py``).

Tolerance: none, every comparison is integer-exact.
"""

import json
import os

import torch

from cuzk_tpu_torch import merkle
from zkbench import common
from zkbench.reference import field as ref_field
from zkbench.reference import merkle as ref_merkle
from zkbench.reference.poseidon import Poseidon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"  # the CPU tests ask for the plain path by name
SEED = 3_300_000_017  # above 2^32, as the benchmark's seeds may be


def test_two_seeded_base_trees_equal_the_reference_level_by_level():
    with open(os.path.join(REPO, "zkbench", "configs",
                           "filecoin-32g-rlast.json")) as fh:
        cfg = json.load(fh)
    arity, trees, n = cfg["arity"], cfg["trees"], 8 ** 3
    assert (arity, trees) == (8, 2) and cfg["leaves"] == 8 ** cfg["levels"]
    leaves = common.random_elements(common.generator(SEED, torch.device(CPU)),
                                    (trees, n), torch.device(CPU))
    built = merkle.build_batch_trees([leaves[t] for t in range(trees)], arity,
                                     device=CPU)
    want = ref_merkle.build_levels(Poseidon(ref_field.Field(torch.device(CPU))),
                                   leaves, arity)
    for t in range(trees):
        got = built[t].levels
        assert [lv.shape[0] for lv in got] == [8 ** 3, 8 ** 2, 8, 1]
        assert len(got) == len(want)
        for level, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w[t]), (t, level)
    assert not torch.equal(built[0].levels[-1], built[1].levels[-1])
