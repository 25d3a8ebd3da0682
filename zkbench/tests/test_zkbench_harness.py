"""The harness finds a new configuration, cell, traffic kind and per-layer
metric reader that are only added as files and entries, without an edit
to any file that is there."""

import json
import os
import time

from zkbench import run

ECHO_KIND = '''
import torch


def setup(ctx):
    return {"ctx": ctx, "x": torch.zeros(ctx.config["width"], dtype=torch.int64,
                                         device=ctx.device), "n": 0}


def request(state, i, record=True):
    with state["ctx"].spans("request"):
        state["x"] = state["x"] + 1
    state["n"] += 1


def end_to_end(state, window_s, requests):
    return {"echo_ms": 1e3 * window_s / requests}


def work(state):
    return {"permutations": 1}


def release(state):
    pass


def control(state, hasher):
    state["x"] = state["x"] * 0


def check(state, hasher):
    return {"echo_wrong": (int((state["x"] != state["n"]).sum()), 0)}
'''

ECHO_READER = '''
def read(view):
    return float(view.requests)
'''


def add_cell(root: str, bench_path: str) -> None:
    with open(bench_path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "echo-8", "source": "https://example.org",
                             "file": "configs/echo-8.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "echo-8.echo", "config": "echo-8",
                               "traffic": "echo", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "echo_ms", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["echo-8.echo"]})
    bench["per_layer"].append({"name": "echo_requests.echo", "unit": "1",
                               "better": "higher", "source": "program_counter",
                               "layer": "Echo", "moves": "echo_ms",
                               "workloads": ["echo-8.echo"]})
    files = {
        "BENCHMARK.json": json.dumps(bench),
        "configs/echo-8.json": json.dumps({"width": 8}),
        "workloads/echo-8.echo.json": json.dumps(
            {"config": "echo-8", "kind": "echo", "params": {"warmup": 1}}),
        "traffic/echo.py": ECHO_KIND,
        "metrics/echo_requests.py": ECHO_READER,
    }
    for name, text in files.items():
        with open(os.path.join(root, name), "w") as fh:
            fh.write(text)


def test_new_files_make_a_new_cell(tmp_path):
    from zkbench.tests.conftest import make_tiny_root

    root = str(tmp_path)
    bench_path = make_tiny_root(root)
    before = {p: open(os.path.join(root, p)).read()
              for p in ("traffic/commit.py", "metrics/idle_pct.py")}
    add_cell(root, bench_path)
    cell = run.load_cell("echo-8.echo", bench_path, root)
    assert sorted(m["name"] for m in cell.end_to_end) == ["echo_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["echo_requests.echo"]

    r = run.run_cell(cell, 3, 0.05, False, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"echo_ms", "setup_s"}
    r = run.run_cell(cell, 3, 0.05, True, "cpu", time.perf_counter())
    assert r["correct"]
    assert r["metrics"]["echo_requests.echo"]["value"] == r["attempted"]
    r = run.run_cell(cell, 3, 0.05, False, "cpu", time.perf_counter(),
                     control=True)
    assert not r["correct"]
    # The cells that were there still load, and their files are unchanged.
    assert run.load_cell("semaphore-d20.commit", bench_path, root).per_layer
    for p, text in before.items():
        assert open(os.path.join(root, p)).read() == text


def test_repository_cells_load():
    with open(run.BENCHMARK_JSON) as fh:
        bench = json.load(fh)
    for w in bench["workloads"]:
        cell = run.load_cell(w["name"])
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.readers) == {m["name"] for m in cell.per_layer}
