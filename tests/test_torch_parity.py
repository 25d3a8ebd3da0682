"""``cuzk_tpu_torch/PARITY.md`` against both packages' public names.

Both packages are walked with ``ast`` (no import of the JAX package): a
public name is a module-level function, class or assignment not starting
with ``_``, or an entry of a package's ``__all__``; modules whose file name
starts with ``_`` are private.  Every JAX module and name must be in the
file, mapped to a port module or name that resolves, or marked "not
ported" with a reason; every port name must be the target of a mapping or
listed as port-only with a reason; and no row may name something that is
gone.
"""

import ast
import importlib
import importlib.util
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(REPO, "cuzk_tpu_torch", "PARITY.md")
PACKAGE = "(package)"


def public_names(pkg: str) -> dict:
    """``{module relative to the package ("" for it): [public names]}``."""
    out = {}
    root_dir = os.path.join(REPO, pkg)
    for root, _, files in os.walk(root_dir):
        if "__pycache__" in root or "_build" in root:
            continue
        for f in sorted(files):
            if not f.endswith(".py") or (f.startswith("_") and f != "__init__.py"):
                continue
            path = os.path.join(root, f)
            rel = os.path.relpath(path, root_dir)[:-3].replace(os.sep, ".")
            mod = "" if rel == "__init__" else rel.removesuffix(".__init__")
            with open(path) as fh:
                tree = ast.parse(fh.read())
            got = []
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    got.append(node.name)
                elif isinstance(node, ast.Assign):
                    got += [t.id for t in node.targets if isinstance(t, ast.Name)]
                    if any(isinstance(t, ast.Name) and t.id == "__all__"
                           for t in node.targets):
                        got = [e.value for e in node.value.elts] + got
                elif isinstance(node, ast.AnnAssign) and isinstance(
                        node.target, ast.Name):
                    got.append(node.target.id)
            out[mod] = [n for n in dict.fromkeys(got) if not n.startswith("_")]
    return out


JAX = public_names("cuzk_tpu")
PORT = public_names("cuzk_tpu_torch")


def qual(mod: str, name: str) -> str:
    return f"{mod}.{name}" if mod else name


def parse_parity():
    """``(modules, names, port_only)``: ``{jax: (port or None, note)}`` for
    the module and name tables, ``{port name: why}`` for the last."""
    with open(PARITY) as f:
        text = f.read()
    sections = re.split(r"^## ", text, flags=re.M)
    tables = {}
    for sec in sections[1:]:
        title = sec.splitlines()[0].strip()
        rows = []
        for line in sec.splitlines():
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if not line.startswith("|") or set(cells[0]) <= {"-", " "}:
                continue
            if cells[0].startswith("`cuzk_tpu"):
                continue  # a header row
            rows.append(cells)
        tables[title] = rows

    def mapping(rows):
        out = {}
        for cells in rows:
            jax = cells[0].strip("`")
            assert jax not in out, f"{jax} appears twice"
            port = None if cells[1] == "not ported" else cells[1].strip("`")
            out[jax] = (port, cells[2] if len(cells) > 2 else "")
        return out

    port_only = {}
    for cells in tables["Port only"]:
        port_only[cells[0].strip("`")] = cells[1]
    return mapping(tables["Modules"]), mapping(tables["Names"]), port_only


MODULES, NAMES, PORT_ONLY = parse_parity()


def resolves(port_qual: str) -> bool:
    """A port name (``module.name``, or a submodule) exists."""
    mod, _, name = port_qual.rpartition(".")
    module = importlib.import_module(
        "cuzk_tpu_torch" + (f".{mod}" if mod else ""))
    return hasattr(module, name) or importlib.util.find_spec(
        f"{module.__name__}.{name}") is not None


def test_every_jax_module_is_listed():
    listed = {("" if m == PACKAGE else m) for m in MODULES}
    assert listed == set(JAX), (
        f"missing {sorted(set(JAX) - listed)}, stale {sorted(listed - set(JAX))}")
    for jax, (port, note) in MODULES.items():
        if port is None:
            assert note, f"module {jax}: 'not ported' needs a reason"
        elif port != PACKAGE:
            assert importlib.util.find_spec(f"cuzk_tpu_torch.{port}"), port


@pytest.mark.parametrize("module", sorted(m for m in JAX if JAX[m]),
                         ids=lambda m: m or PACKAGE)
def test_every_jax_name_is_mapped_or_not_ported(module):
    for name in JAX[module]:
        q = qual(module, name)
        assert q in NAMES, f"cuzk_tpu.{q} is not in PARITY.md"
        port, note = NAMES[q]
        if port is None:
            assert note, f"cuzk_tpu.{q}: 'not ported' needs a reason"
        else:
            assert resolves(port), f"cuzk_tpu.{q} -> cuzk_tpu_torch.{port}"


def test_no_row_names_a_jax_name_that_is_gone():
    current = {qual(m, n) for m, ns in JAX.items() for n in ns}
    assert set(NAMES) <= current, sorted(set(NAMES) - current)


@pytest.mark.parametrize("module", sorted(m for m in PORT if PORT[m]),
                         ids=lambda m: m or PACKAGE)
def test_every_port_name_is_a_counterpart_or_port_only(module):
    targets = {port for port, _ in NAMES.values() if port}
    for name in PORT[module]:
        q = qual(module, name)
        assert q in targets or q in PORT_ONLY, (
            f"cuzk_tpu_torch.{q} is neither a counterpart nor port-only")
        if q in PORT_ONLY:
            assert PORT_ONLY[q], f"port-only {q} needs a reason"
            assert q not in targets, f"{q} is mapped and also port-only"


def test_no_port_only_row_is_stale():
    current = {qual(m, n) for m, ns in PORT.items() for n in ns}
    assert set(PORT_ONLY) <= current, sorted(set(PORT_ONLY) - current)


def test_the_walk_sees_the_slice6_names():
    """The walk itself: names this slice adds are public names of the port
    and map from their JAX names."""
    assert NAMES["merkle.engine_path"][0] == "merkle.engine_path"
    assert NAMES["field.fr.sub"][0] == "field.fr.sub"
    assert NAMES["field.batch.BatchFieldArithmetic"][0] == \
        "field.batch.BatchFieldArithmetic"
    assert NAMES["native.ensure_built"][0] == "native.build_oracle"
    assert NAMES["engine.PallasPoseidonEngine"][0] == "engine.CudaPoseidonEngine"
    assert NAMES["utils.compilecache.enable_compile_cache"][0] is None
    assert "oracle" in PORT[""] and "reduce_512" in PORT["oracle"]
