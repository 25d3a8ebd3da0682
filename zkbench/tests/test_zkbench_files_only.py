"""A configuration and a cell added as files alone (the configuration's
file, the workload's, their two tiny files and new entries in
``BENCHMARK.json``), in a copy of the benchmark in which no file that is
there is edited: the tiny root takes them, the cell loads with the metrics
it is listed under, a tiny CPU run is correct and its control is not."""

import hashlib
import json
import os
import time

import pytest

from zkbench import run
from zkbench.tests.conftest import add_cell, copy_benchmark, make_tiny_root

SEED = 2_147_483_659
CONF = {"name": "test-a8", "source": "https://example.org",
        "file": "zkbench/configs/test-a8.json", "reduced": [],
        "why": "a test: arity 8, which no cell of the repository runs"}
CELL = {"name": "test-a8.commit", "config": "test-a8", "traffic": "commit",
        "chips": 1, "why": "a test"}
CFG = {"leaves": 4096, "arity": 8}
WORKLOAD = {"config": "test-a8", "kind": "commit",
            "params": {"sets": 4, "checked_sets": 1, "warmup": 2}}


def digests(repo):
    out = {}
    for d, _, files in os.walk(repo):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, repo)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


@pytest.fixture
def added(tmp_path):
    repo = copy_benchmark(str(tmp_path / "repo"))
    before = digests(repo)
    add_cell(repo, CONF, CFG, CELL, WORKLOAD, "commit_ms",
             {"leaves": 64}, {"sets": 2, "checked_sets": 1, "warmup": 1})
    return repo, before


def test_added_files_edit_nothing_that_is_there(added):
    repo, before = added
    after = digests(repo)
    changed = {p for p in before if after.get(p) != before[p]}
    assert changed == {"BENCHMARK.json"}
    assert len(set(after) - set(before)) == 4
    with open(os.path.join(run.REPO, "BENCHMARK.json")) as fh:
        old = json.load(fh)
    with open(os.path.join(repo, "BENCHMARK.json")) as fh:
        new = json.load(fh)
    for m in new["end_to_end"] + new["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w != CELL["name"]]
    new["configs"].remove(CONF)
    new["workloads"].remove(CELL)
    assert new == old


def test_added_cell_runs_at_the_tiny_size(added, tmp_path):
    repo, _ = added
    root = str(tmp_path / "tiny")
    bench = make_tiny_root(root, repo=repo)
    cell = run.load_cell(CELL["name"], bench, root)
    assert cell.config["leaves"] == 64 and cell.config["arity"] == 8
    assert cell.params == {"sets": 2, "checked_sets": 1, "warmup": 1}
    assert sorted(m["name"] for m in cell.end_to_end) == ["commit_ms", "setup_s"]
    assert {m["name"] for m in cell.per_layer} >= {"idle_pct.commit",
                                                    "host_ms.commit"}
    r = run.run_cell(cell, SEED, 0.01, False, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"commit_ms", "setup_s"}
    r = run.run_cell(cell, SEED, 0.01, False, "cpu", time.perf_counter(),
                     control=True)
    assert not r["correct"], r["checks"]
    # The cells that were there load as before.
    for name in ("semaphore-d20.commit", "cuzk-a4-50k.verify"):
        assert run.load_cell(name, bench, root).per_layer


@pytest.mark.parametrize("kind,name", [("configs", "test-a8"),
                                       ("workloads", "test-a8.commit")])
def test_a_missing_tiny_file_is_named(added, tmp_path, kind, name):
    repo, _ = added
    missing = os.path.join("zkbench", "tests", "tiny", kind, name + ".json")
    os.remove(os.path.join(repo, missing))
    with pytest.raises(FileNotFoundError, match=missing.replace(".", r"\.")):
        make_tiny_root(str(tmp_path / "tiny"), repo=repo)
