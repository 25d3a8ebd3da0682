"""What the benchmark loads, by top-level module name compared whole: no
JAX and no JAX package (``cuzk_tpu``) anywhere, and nothing of this
repository's packages in the reference."""

import ast
import glob
import json
import os
import subprocess
import sys

from zkbench import run

ZKBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from zkbench import run, trace, common, roofline, calibrate_imad
from zkbench.tests.conftest import make_tiny_root
import tempfile
names = [w["name"] for w in json.load(open(run.BENCHMARK_JSON))["workloads"]]
for name in names:
    run.load_cell(name)
with tempfile.TemporaryDirectory() as root:
    bench = make_tiny_root(root)
    cell = run.load_cell("cuzk-a4-50k.verify", bench, root)
    r = run.run_cell(cell, 5, 0.01, False, "cpu", time.perf_counter())
print(json.dumps({"correct": r["correct"],
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", PROBE, run.REPO],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"]
    top = set(res["top"])
    assert "cuzk_tpu_torch" in top
    assert not top & set(run.FORBIDDEN_MODULES), top & set(run.FORBIDDEN_MODULES)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cuzk_tpu_torch_probe", sys)
    assert "cuzk_tpu_torch_probe" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cuzk_tpu.oracle", sys)
    assert run.forbidden_modules() == ["cuzk_tpu"]


def test_reference_imports_nothing_of_the_repository():
    allowed = {"__future__", "typing", "torch", "zkbench"}
    for path in glob.glob(os.path.join(ZKBENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top in allowed, (path, n)
                if top == "zkbench":
                    assert n.startswith("zkbench.reference"), (path, n)
    probe = ("import sys; sys.path.insert(0, sys.argv[1]);"
             "import zkbench.reference.merkle, zkbench.reference.field;"
             "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", probe, run.REPO],
                         capture_output=True, text=True, timeout=300)
    top = set(ast.literal_eval(out.stdout.strip()))
    assert not top & {"cuzk_tpu", "cuzk_tpu_torch", "jax", "jaxlib", "flax"}
