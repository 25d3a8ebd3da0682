"""A tiny benchmark root for the CPU tests: the repository's traffic kinds
and metric readers beside tiny configurations and cells, all run through
the port's CPU path.  A configuration's or a cell's tiny size is a file of
its own, ``tiny/configs/<config>.json`` or ``tiny/workloads/<cell>.json``,
holding the keys (configuration) or parameters (cell) to override.
Besides the repository's cells it holds one of the ``update`` traffic
kind, which no cell of ``BENCHMARK.json`` uses yet, so that the kind and
the ``kernel_ms`` reader stay tested until a cell with sourced parameters
takes them up."""

import json
import os
import shutil
import sys

import pytest

ZKBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(ZKBENCH)
if REPO not in sys.path:
    sys.path.insert(0, REPO)

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


def tiny_override(repo: str, kind: str, name: str) -> dict:
    """The keys that ``zkbench/tests/tiny/<kind>/<name>.json`` of the
    benchmark in ``repo`` overrides at the tiny size."""
    path = os.path.join(repo, "zkbench", "tests", "tiny", kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no tiny size for {name!r}: add {os.path.relpath(path, repo)} "
            "with the keys to override at the tiny size")
    with open(path) as fh:
        return json.load(fh)


def make_tiny_root(root: str, repo: str = REPO) -> str:
    """Copy the benchmark of ``repo`` into ``root`` with its configurations
    and cells cut to the tiny sizes of ``zkbench/tests/tiny/``; returns the
    path of the copy's BENCHMARK.json."""
    zkbench = os.path.join(repo, "zkbench")
    with open(os.path.join(repo, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["workloads"].append(UPDATE_CELL)
    for key, metrics in UPDATE_METRICS.items():
        bench[key] += metrics
    os.makedirs(os.path.join(root, "configs"))
    os.makedirs(os.path.join(root, "workloads"))
    for c in bench["configs"]:
        with open(os.path.join(repo, c["file"])) as fh:
            cfg = json.load(fh)
        cfg.update(tiny_override(repo, "configs", c["name"]))
        c["file"] = f"configs/{c['name']}.json"
        with open(os.path.join(root, c["file"]), "w") as fh:
            json.dump(cfg, fh)
    for w in bench["workloads"]:
        if w is UPDATE_CELL:
            wl = {"config": w["config"], "kind": w["traffic"]}
        else:
            with open(os.path.join(zkbench, "workloads",
                                   w["name"] + ".json")) as fh:
                wl = json.load(fh)
        wl["params"] = {**wl.get("params", {}),
                        **tiny_override(repo, "workloads", w["name"])}
        with open(os.path.join(root, "workloads", w["name"] + ".json"), "w") as fh:
            json.dump(wl, fh)
    for d in ("traffic", "metrics"):
        shutil.copytree(os.path.join(zkbench, d), os.path.join(root, d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as fh:
        json.dump(bench, fh)
    return path


def copy_benchmark(dst: str) -> str:
    """``BENCHMARK.json`` and ``zkbench/`` of the repository in ``dst``, as
    a checkout holds them; returns ``dst``."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(ZKBENCH, os.path.join(dst, "zkbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    return dst


def add_cell(repo: str, conf: dict, cfg: dict, cell: dict, workload: dict,
             metric: str, tiny_cfg: dict, tiny_params: dict) -> None:
    """Add a configuration and a cell to the benchmark in ``repo`` as files
    alone: ``conf`` and ``cell`` are their entries in ``BENCHMARK.json``,
    ``cfg`` and ``workload`` their files, ``tiny_cfg`` and ``tiny_params``
    their tiny files; the cell is listed under the end-to-end ``metric`` and
    every per-layer metric that moves it."""
    files = {
        conf["file"]: cfg,
        f"zkbench/workloads/{cell['name']}.json": workload,
        f"zkbench/tests/tiny/configs/{conf['name']}.json": tiny_cfg,
        f"zkbench/tests/tiny/workloads/{cell['name']}.json": tiny_params,
    }
    for name, data in files.items():
        path = os.path.join(repo, name)
        if os.path.exists(path):
            raise FileExistsError(path)
        with open(path, "w") as fh:
            json.dump(data, fh)
    path = os.path.join(repo, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append(conf)
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if metric in (m["name"], m.get("moves")) and "workloads" in m:
            m["workloads"].append(cell["name"])
    with open(path, "w") as fh:
        json.dump(bench, fh, indent=2)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zkbench_tiny"))
    return root, make_tiny_root(root)
