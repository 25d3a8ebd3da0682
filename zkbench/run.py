"""Run one cell of the benchmark once and print its result line.

    python -m zkbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name, from data: its entry in ``BENCHMARK.json`` (the
configuration, the chips, which metrics it reports),
``zkbench/workloads/<name>.json`` (its traffic kind and that kind's
parameters), the configuration's file, ``zkbench/traffic/<kind>.py`` (set-up,
one request, the end-to-end metrics, the check) and, for each per-layer
metric, the reader ``zkbench/metrics/<stem>.py`` named by the part of the
metric's name before its first dot.  A cell, a configuration or a
per-layer metric is added by adding files and an entry, never by editing
a file that is there.

A run makes its inputs on the card from ``--seed``, sets up and warms the
cell's shapes (``setup_s``, from the process's start), then runs the
traffic as a closed loop for ``--seconds``; with ``--trace 1`` under
``torch.profiler``, reporting the per-layer metrics instead of the
end-to-end ones.  Once the window has closed and the device's memory peak
is read, the plain reference (``zkbench/reference/``) recomputes what was
produced and every number compared is printed beside its limit.  The last
line of standard output is the JSON result.  Without a card it exits 2 and
prints no result; it exits 3 if JAX or the JAX package was loaded.

``--control`` replaces every output with what the reference computes with
the cuZK CUDA sources' reduction constant (k + 4): the check must then fail
(a calibration run, never the benchmark's).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(ROOT)
BENCHMARK_JSON = os.path.join(REPO, "BENCHMARK.json")
# Top-level module names the measured process must never load: JAX and the
# JAX package (compared whole: the port's name begins with the latter's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cuzk_tpu")


def _load_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    params: dict
    kind: object
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object] = field(default_factory=dict)


def load_cell(name: str, benchmark_json: str = BENCHMARK_JSON,
              root: str = ROOT) -> Cell:
    """The cell ``name`` and everything it names, found by name."""
    bench = _load_json(benchmark_json)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {benchmark_json}")
    workload = _load_json(os.path.join(root, "workloads", name + ".json"))
    if workload["config"] != entry["config"]:
        raise ValueError(f"{name}: workload file names config "
                         f"{workload['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _load_json(os.path.join(os.path.dirname(benchmark_json),
                                     conf["file"]))
    kind = _load_module(os.path.join(root, "traffic", workload["kind"] + ".py"),
                        "zkbench_traffic_" + workload["kind"])
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    readers = {}
    for m in per_layer:
        stem = m["name"].split(".")[0]
        readers[m["name"]] = _load_module(
            os.path.join(root, "metrics", stem + ".py"), "zkbench_metric_" + stem)
    return Cell(name, int(entry["chips"]), config,
                workload.get("params", {}), kind, end_to_end, per_layer,
                readers)


@dataclass
class Context:
    """What a traffic kind is handed: where to run, the seed, the
    configuration and the cell's parameters, the program under test, and
    the benchmark's spans."""

    device: object
    seed: int
    config: dict
    params: dict
    program: object
    spans: object


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, control: bool = False, program=None) -> dict:
    """One run of ``cell``: set-up, warm-up, the window, the metrics, the
    check.  ``program`` is the port's Merkle module unless a test hands
    another."""
    import torch

    from zkbench import trace as trace_mod
    from zkbench.reference import constants, field as ref_field, poseidon

    if program is None:
        from cuzk_tpu_torch import merkle as program
    device = torch.device(device)
    spans = trace_mod.Spans(trace)
    ctx = Context(device, seed, cell.config, cell.params, program, spans)
    kind = cell.kind
    if device.type == "cuda":
        torch.empty(1, device=device)  # the allocator starts with the context
        torch.cuda.reset_peak_memory_stats(device)
    state = kind.setup(ctx)
    warmup = int(cell.params.get("warmup", 2))
    for i in range(warmup):
        kind.request(state, i, record=False)
    _sync(device)
    setup_s = time.perf_counter() - t0

    prof = trace_mod.Profiler() if trace else contextlib.nullcontext()
    attempted = failed = 0
    with prof:
        with spans("window"):
            start = time.perf_counter()
            deadline = start + seconds
            while True:
                try:
                    kind.request(state, warmup + attempted)
                except Exception:  # a failed request is counted, not fatal
                    if failed == 0:
                        traceback.print_exc()
                    failed += 1
                attempted += 1
                if time.perf_counter() >= deadline:
                    break
            _sync(device)
            window_s = time.perf_counter() - start

    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    metrics: Dict[str, dict] = {}
    breakdown = None
    dev_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu"),
        "count": cell.chips,
        "memory_peak_bytes": int(memory_peak),
    }
    if trace:
        view = prof.view(attempted - failed, kind.work(state))
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = view.busy_s
        dev_info["window_s"] = view.window_s
        breakdown = {"device_ops": [list(x) for x in view.device_ops],
                     "idle_gaps": [list(x) for x in view.idle_gaps]}
    else:
        values = kind.end_to_end(state, window_s, attempted - failed) \
            if attempted > failed else {}
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    if device.type == "cuda":
        dev_info["power_limit"] = _power_limit()

    kind.release(state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check_start = time.perf_counter()
    if control:
        kind.control(state, poseidon.Poseidon(
            ref_field.Field(device, constants.K_CUDA)))
    checks = kind.check(state, poseidon.Poseidon(ref_field.Field(device)))
    compared = checks.pop("_compared", {})
    compared["check_s"] = time.perf_counter() - check_start
    # A request that failed is an answer that never came.
    correct = (failed == 0 and attempted > 0
               and all(v <= lim for v, lim in checks.values()))
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": dev_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"zkbench: the cell needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0, control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"zkbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"requests failed: {result['failed']} of {result['attempted']}"
          " (any failure makes the run not correct)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
