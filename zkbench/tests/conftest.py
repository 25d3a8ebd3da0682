"""A tiny benchmark root for the CPU tests: the repository's traffic kinds
and metric readers beside tiny configurations and cells, all run through
the port's CPU path.  Besides the repository's cells it holds one of the
``update`` traffic kind, which no cell of ``BENCHMARK.json`` uses yet, so
that the kind and the ``kernel_ms`` reader stay tested until a cell with
sourced parameters takes them up."""

import json
import os
import shutil
import sys

import pytest

ZKBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ZKBENCH)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_LEAVES = {"cuzk-a4-50k": 40, "semaphore-d20": 16}
TINY_PARAMS = {
    "semaphore-d20.commit": {"sets": 2, "checked_sets": 1, "warmup": 1},
    "cuzk-a4-50k.commit": {"sets": 2, "checked_sets": 2, "warmup": 1},
    "cuzk-a4-50k.verify": {"batches": 2, "proofs": 10, "tampered_share": 0.2,
                           "warmup": 1},
    "semaphore-d20.update64": {"batch": 3, "index_batches": 4, "pool": 3,
                               "warmup": 1},
}
# The update cell of the tiny root: its entry, kind and metrics.
UPDATE_CELL = {"name": "semaphore-d20.update64", "config": "semaphore-d20",
               "traffic": "update", "chips": 1, "why": "a test"}
UPDATE_METRICS = {
    "end_to_end": [{"name": "update_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": ["semaphore-d20.update64"]}],
    "per_layer": [
        {"name": f"{stem}.update", "unit": unit, "better": "lower",
         "source": "device_trace", "layer": layer, "moves": "update_ms",
         "workloads": ["semaphore-d20.update64"]}
        for stem, unit, layer in (("idle_pct", "%", "Device"),
                                  ("kernel_ms", "ms", "Kernels"),
                                  ("torch_ops_ms", "ms",
                                   "Tree logic and wrappers"))],
}


def make_tiny_root(root: str) -> str:
    """Copy the benchmark's code into ``root`` with tiny configurations and
    cells; returns the path of its BENCHMARK.json."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append(UPDATE_CELL)
    for key, metrics in UPDATE_METRICS.items():
        bench[key] += metrics
    os.makedirs(os.path.join(root, "configs"))
    os.makedirs(os.path.join(root, "workloads"))
    for c in bench["configs"]:
        with open(os.path.join(REPO, c["file"])) as fh:
            cfg = json.load(fh)
        cfg["leaves"] = TINY_LEAVES[c["name"]]
        c["file"] = f"configs/{c['name']}.json"
        with open(os.path.join(root, c["file"]), "w") as fh:
            json.dump(cfg, fh)
    for w in bench["workloads"]:
        if w is UPDATE_CELL:
            wl = {"config": w["config"], "kind": w["traffic"]}
        else:
            with open(os.path.join(ZKBENCH, "workloads",
                                   w["name"] + ".json")) as fh:
                wl = json.load(fh)
        wl["params"] = {**wl.get("params", {}), **TINY_PARAMS[w["name"]]}
        with open(os.path.join(root, "workloads", w["name"] + ".json"), "w") as fh:
            json.dump(wl, fh)
    for d in ("traffic", "metrics"):
        shutil.copytree(os.path.join(ZKBENCH, d), os.path.join(root, d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as fh:
        json.dump(bench, fh)
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zkbench_tiny"))
    return root, make_tiny_root(root)
