"""The ``sampled_commit`` traffic kind at a tiny size on the CPU: 2 trees of
8^3 leaves at arity 8 with ``sample_rows`` 16, so that level 1 (64 rows)
is sampled and the levels above it are judged whole.  A sound run is
correct, the control is not, nor is a run with one of these faults planted
where the answer is produced, on every seed tried: the last row of level 1
altered, the previous commit's levels returned, the first commit's levels
returned for ever, the second tree left out, the root altered.  Inputs and
writes follow the seed."""

import contextlib
import time

import pytest
import torch

from cuzk_tpu_torch import merkle
from zkbench import common, run
from zkbench.tests.conftest import add_cell, copy_benchmark, make_tiny_root

SEEDS = (2_147_483_659, 3_100_007_919)
NAME = "test-sampled-a8.commit"


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sampled")
    repo = copy_benchmark(str(tmp / "repo"))
    add_cell(repo,
             {"name": "test-sampled-a8", "source": "https://example.org",
              "file": "zkbench/configs/test-sampled-a8.json", "reduced": [],
              "why": "a test"},
             {"leaves": 8 ** 6, "arity": 8, "trees": 2},
             {"name": NAME, "config": "test-sampled-a8",
              "traffic": "sampled_commit", "chips": 1, "why": "a test"},
             {"config": "test-sampled-a8", "kind": "sampled_commit",
              "params": {"warmup": 2}},
             "commit_ms", {"leaves": 8 ** 3}, {"sample_rows": 16, "warmup": 1})
    root = str(tmp / "tiny")
    return run.load_cell(NAME, make_tiny_root(root, repo=repo), root)


def run_tiny(cell, seed=SEEDS[0], control=False, program=None):
    return run.run_cell(cell, seed, 0.01, False, "cpu", time.perf_counter(),
                        control=control, program=program)


def test_sound_run_is_correct(cell):
    r = run_tiny(cell)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"rows_wrong", "stale_roots"}
    assert set(r["metrics"]) == {"commit_ms", "setup_s"}
    # Level 1 is sampled: 16 drawn rows, its ends and the written paths, at
    # most 20 of its 64 rows a tree; levels 2 and 3 whole.
    assert 2 * (16 + 8 + 1) <= r["compared"]["rows"] <= 2 * (20 + 8 + 1)
    assert r["compared"]["commits"] >= 2


def test_control_is_not_correct(cell):
    r = run_tiny(cell, control=True)
    assert not r["correct"]
    assert r["checks"]["rows_wrong"]["value"] > 0


class Faulty:
    """The port's ``build_tree_levels`` with one fault planted where the
    answer is produced."""

    def __init__(self, fault):
        self.fault = fault
        self.calls = 0
        self.last = {}
        self.first = {}

    def build_tree_levels(self, leaves, arity):
        call, self.calls = self.calls, self.calls + 1
        tree = call % 2
        if self.fault == "second_tree_left_out" and tree == 1:
            return self.last[0]
        if self.fault == "unchanged" and tree in self.first:
            return self.first[tree]
        levels = merkle.build_tree_levels(leaves, arity)
        if self.fault == "last_row_of_level_1":
            levels[1] = levels[1].clone()
            levels[1][-1, 0] ^= 1
        elif self.fault == "root_altered":
            levels[-1] = levels[-1].clone()
            levels[-1][0, 3] ^= 1
        out = self.last.get(tree, levels) if self.fault == "stale" else levels
        self.last[tree] = levels
        self.first.setdefault(tree, levels)
        return out


FAULTS = {"last_row_of_level_1": "rows_wrong", "stale": "rows_wrong",
          "unchanged": "stale_roots", "second_tree_left_out": "rows_wrong",
          "root_altered": "rows_wrong"}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(cell, fault, seed):
    r = run_tiny(cell, seed, program=Faulty(fault))
    assert not r["correct"], r["checks"]
    assert r["failed"] == 0
    assert r["checks"][FAULTS[fault]]["value"] > 0


class Echo:
    """A program whose levels are the leaves and one row of them: the
    writes, not the hashing, are under test."""

    def build_tree_levels(self, leaves, arity):
        return [leaves, leaves[:1].clone()]


def writes(cell, seed, requests=4):
    ctx = run.Context(torch.device("cpu"), seed, cell.config, cell.params,
                      Echo(), lambda name: contextlib.nullcontext())
    state = cell.kind.setup(ctx)
    first = state["leaves"].clone()
    for i in range(requests):
        cell.kind.request(state, i)
    return first, state


def test_inputs_and_writes_follow_the_seed(cell):
    (a0, a), (b0, b), (c0, c) = (writes(cell, s)
                                 for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    assert a0.shape == (2, 8 ** 3, 16)
    assert torch.equal(a0, b0) and torch.equal(a["leaves"], b["leaves"])
    assert not torch.equal(a0, c0)
    for (i, ia, oa), (j, ib, ob) in zip(a["log"], b["log"]):
        assert i == j and torch.equal(ia, ib) and torch.equal(oa, ob)
    assert [i for i, *_ in a["log"]] == [0, 1, 2, 3]
    assert not all(torch.equal(x[1], y[1]) for x, y in zip(a["log"], c["log"]))
    # Each request changes one leaf a tree, and the log undoes it.
    changed = (a0 != a["leaves"]).any(dim=-1).sum(dim=-1)
    assert 1 <= int(changed.min()) and int(changed.max()) <= 4
    undone = a["leaves"].clone()
    for _, idx, old in reversed(a["log"]):
        undone[torch.arange(2), idx] = old
    assert torch.equal(undone, a0)


def test_a_write_never_repeats_the_old_value(cell, monkeypatch):
    _, state = writes(cell, SEEDS[0], requests=0)
    state["leaves"].zero_()
    monkeypatch.setattr(common, "random_elements",
                        lambda g, shape, device: torch.zeros(
                            tuple(shape) + (16,), dtype=torch.int64))
    cell.kind.request(state, 0)
    _, idx, old = state["log"][0]
    assert not bool(old.any())
    written = state["leaves"][torch.arange(2), idx]
    assert written[:, 0].tolist() == [1, 1] and not bool(written[:, 1:].any())

