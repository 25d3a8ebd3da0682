"""Each cell driven end to end at a tiny size through the port's CPU path:
sound runs come out correct, the control (the reference computing with
the cuZK CUDA sources' k + 4 in the program's place) does not, nor does a
run with the timed path broken underneath; inputs follow the seed; the
measured command refuses a machine without a card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from cuzk_tpu_torch import merkle
from zkbench import run
from zkbench.tests.conftest import UPDATE_CELL

# Every cell of BENCHMARK.json and the tiny root's update cell, with its
# traffic kind, so that a cell added as files is driven here too.
with open(run.BENCHMARK_JSON) as _fh:
    KINDS = {w["name"]: w["traffic"] for w in json.load(_fh)["workloads"]}
KINDS[UPDATE_CELL["name"]] = UPDATE_CELL["traffic"]
CELLS = list(KINDS)
SEED = 2_147_483_659  # above 2^31, as the driver's seeds are


def run_tiny(tiny_root, name, seed=SEED, trace=False, control=False,
             program=None):
    root, bench = tiny_root
    cell = run.load_cell(name, bench, root)
    return run.run_cell(cell, seed, 0.01, trace, "cpu", time.perf_counter(),
                        control=control, program=program)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_root, name):
    r = run_tiny(tiny_root, name)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics"]
    assert len(r["metrics"]) == 2
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_root, name):
    r = run_tiny(tiny_root, name, control=True)
    assert not r["correct"], r["checks"]


class Faulty:
    """The port's Merkle entry points with one fault planted where the
    answer is produced."""

    def __init__(self, fault, timed):
        self.fault = fault
        self.timed = timed
        self.generate_proofs = merkle.generate_proofs

    def build_tree_levels(self, leaves, arity):
        if self.timed != "build_tree_levels":
            return merkle.build_tree_levels(leaves, arity)
        if self.fault == "half_left_out":
            leaves = leaves[: leaves.shape[0] // 2]
        levels = merkle.build_tree_levels(leaves, arity)
        if self.fault == "answer_altered":
            levels[-1] = levels[-1].clone()
            levels[-1][0, 0] ^= 1
        return levels

    def verify_each(self, positions, siblings, leaves, root, arity):
        k = positions.shape[0]
        if self.fault == "half_left_out":
            out = merkle.verify_each(positions[: k // 2], siblings[: k // 2],
                                     leaves[: k // 2], root, arity)
            return list(out) + [False] * (k - k // 2)
        out = merkle.verify_each(positions, siblings, leaves, root, arity)
        if self.fault == "answer_altered":
            out = out.copy()
            out[0] = not out[0]
        return out

    def update_tree_levels(self, levels, arity, indices, values):
        if self.fault == "state_unchanged":
            return levels
        if self.fault == "half_left_out":
            k = len(indices)
            indices, values = indices[: k // 2], values[: k // 2]
        new = merkle.update_tree_levels(levels, arity, indices, values)
        if self.fault == "answer_altered":
            new[-1] = new[-1].clone()
            new[-1][0, 0] ^= 1
        return new


# The program's entry point that each traffic kind times.
TIMED_BY_KIND = {"commit": "build_tree_levels",
                 "sampled_commit": "build_tree_levels",
                 "verify": "verify_each",
                 "update": "update_tree_levels"}
TIMED = {name: TIMED_BY_KIND[kind] for name, kind in KINDS.items()}
FAULTS = [(c, f) for c in CELLS for f in ("answer_altered", "half_left_out")]
FAULTS.append(("semaphore-d20.update64", "state_unchanged"))


@pytest.mark.parametrize("name,fault", FAULTS)
def test_broken_timed_path_is_not_correct(tiny_root, name, fault):
    r = run_tiny(tiny_root, name, program=Faulty(fault, TIMED[name]))
    assert not r["correct"], r["checks"]


def test_traced_run_reports_the_window(tiny_root):
    r = run_tiny(tiny_root, "semaphore-d20.update64", trace=True)
    assert r["correct"]
    assert r["device"]["window_s"] > 0
    assert {"device_ops", "idle_gaps"} <= set(r["breakdown"])
    names = [n for n, _ in r["breakdown"]["idle_gaps"]]
    assert "zkbench.request" in names


@pytest.mark.parametrize("name", CELLS)
def test_inputs_follow_the_seed(tiny_root, name):
    root, bench = tiny_root
    cell = run.load_cell(name, bench, root)

    def inputs(seed):
        ctx = run.Context(torch.device("cpu"), seed, cell.config, cell.params,
                          merkle, lambda n: __import__("contextlib").nullcontext())
        state = cell.kind.setup(ctx)
        return [v for k, v in sorted(state.items())
                if k in ("leaves", "idx", "pool", "tamper")]

    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        return bool((torch.as_tensor(a) == torch.as_tensor(b)).all())

    a, b, c = inputs(SEED), inputs(SEED), inputs(SEED + 1)
    assert all(same(x, y) for x, y in zip(a, b))
    assert not same(a[0], c[0])


def test_measured_command_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "zkbench.run", "--workload",
         "semaphore-d20.commit", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, cwd=run.REPO, timeout=120)
    assert out.returncode == 2
    assert out.stdout == ""


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "zkbench.run", "--workload",
         "cuzk-a4-50k.commit", "--seed", "11", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, cwd=run.REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": run.REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
