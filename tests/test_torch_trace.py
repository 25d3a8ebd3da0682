"""``cuzk_tpu_torch.utils.trace``: spans and counters recorded only while a
``torch.profiler`` session records, on the CPU.

Without a session a span is the shared no-op and nothing is recorded.
Under one, each span lands in the profiler's events under ``cuzk.<name>``
and in the module's table (self time, wait time, the request its root
took), counters count, and kernel launches are the session's change of
``ops.poseidon_cuda.launch_counts``.  The Merkle entry points open one root
span a call, and a traced tiny run of each benchmark cell reads the
port's host time from them.
"""

import json
import os
import sys
import threading
import time
import types

import pytest
import torch
import torch.autograd.profiler
from torch.profiler import ProfilerActivity, profile

from cuzk_tpu_torch import merkle
from cuzk_tpu_torch.ops import poseidon_cuda
from cuzk_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2_147_483_659  # above 2^31, as the benchmark's seeds are


def session():
    return profile(activities=[ProfilerActivity.CPU])


def rows(totals):
    return {(r["name"], r["parent"]): r for r in totals["spans"]}


def test_the_profiler_flag_is_where_the_module_reads_it():
    assert torch.autograd.profiler._is_profiler_enabled is False
    with session():
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_without_a_session_a_span_is_the_shared_noop():
    before = trace.totals()
    first = trace.span("a")
    assert first is trace.span("b", wait=True)
    with first:
        with trace.span("c"):
            trace.count("n", 3)
    merkle.build_tree_levels(torch.zeros((5, 16), dtype=torch.int64), 2)
    assert trace.totals() == before


def test_spans_land_in_the_profiler_with_self_and_wait_time():
    with session() as prof:
        with trace.span("root"):
            time.sleep(0.002)
            with trace.span("child"):
                time.sleep(0.003)
            with trace.span("wait", wait=True):
                time.sleep(0.004)
    names = {e.key for e in prof.key_averages()}
    assert {"cuzk.root", "cuzk.child", "cuzk.wait"} <= names
    t = trace.totals()
    r = rows(t)
    root = r[("cuzk.root", None)]
    child = r[("cuzk.child", "cuzk.root")]
    wait = r[("cuzk.wait", "cuzk.root")]
    assert t["requests"] == 1 and root["count"] == 1
    assert root["self_s"] == pytest.approx(
        root["total_s"] - child["total_s"] - wait["total_s"], abs=1e-9)
    assert root["self_s"] >= 0.002 and child["self_s"] >= 0.003
    assert t["root_s"] == root["total_s"]
    assert t["wait_s"] == wait["total_s"] >= 0.004
    assert wait["wait"] and not child["wait"]


def test_children_carry_their_root_request_number(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def recording(name, args=None):
        opened.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", recording)
    with session():
        for _ in range(2):
            with trace.span("root"):
                with trace.span("child"):
                    with trace.span("grandchild"):
                        pass
    assert [n for n, _ in opened] == ["cuzk.root", "cuzk.child",
                                      "cuzk.grandchild"] * 2
    first, second = opened[:3], opened[3:]
    assert len({a for _, a in first}) == 1 and len({a for _, a in second}) == 1
    assert first[0][1] != second[0][1]
    assert trace.totals()["requests"] == 2


def test_a_second_session_starts_empty_and_counters_count_while_recording():
    with session():
        trace.count("n", 2)
        with trace.span("root"):
            pass
    trace.count("n", 5)
    with trace.span("root"):
        pass
    t = trace.totals()
    assert t["counters"]["n"] == 2 and t["requests"] == 1
    with session():
        with trace.span("other"):
            pass
    t = trace.totals()
    assert "n" not in t["counters"] and t["requests"] == 1
    assert set(rows(t)) == {("cuzk.other", None)}


def test_threads_share_one_table_without_losing_a_span():
    """More threads than cores, a short switch interval: every root, child
    and count of every thread lands in the table, each child under its
    own thread's root."""
    threads, roots = 2 * (os.cpu_count() or 4), 200
    interval = sys.getswitchinterval()

    def work():
        for _ in range(roots):
            with trace.span("root"):
                with trace.span("child"):
                    trace.count("n")

    sys.setswitchinterval(1e-6)
    try:
        with session():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=120)
            assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    t = trace.totals()
    r = rows(t)
    assert t["requests"] == threads * roots
    assert t["counters"]["n"] == threads * roots
    assert r[("cuzk.child", "cuzk.root")]["count"] == threads * roots
    assert set(r) == {("cuzk.root", None), ("cuzk.child", "cuzk.root")}


def test_launches_are_the_sessions_change_of_launch_counts(monkeypatch):
    monkeypatch.setitem(poseidon_cuda.launch_counts, "sponge", 100)
    monkeypatch.setitem(poseidon_cuda.launch_counts, "verify", 50)
    poseidon_cuda.launch_counts["verify"] += 7  # before the session
    with session():
        with trace.span("root"):
            poseidon_cuda.launch_counts["sponge"] += 3
    poseidon_cuda.launch_counts["sponge"] += 4  # after it
    c = trace.totals()["counters"]
    assert c["launch.sponge"] == 3 and c["launch.verify"] == 0


def _fake_launches(monkeypatch):
    """K1's and K3's launchers on CPU tensors with every kernel call a
    no-op: the wrappers still pick G from the batch, count the launch and
    record their counters.  A card holds 84,480 states at G = 1."""
    monkeypatch.setattr(poseidon_cuda._build, "kernels",
                        lambda: types.SimpleNamespace(lib=types.SimpleNamespace(
                            cuzk_sponge=None, cuzk_sponge_digits=None,
                            cuzk_verify_digits=None)))
    monkeypatch.setattr(poseidon_cuda, "_check_limbs", lambda *a: None)
    monkeypatch.setattr(poseidon_cuda, "_launch", lambda *a: None)
    monkeypatch.setattr(poseidon_cuda, "resident_states", lambda *a: 84_480)

    def calls():
        i32 = torch.int32
        with trace.span("root"):
            for rows in (64, 65_536, 70_000):  # G = 3, 1, 1
                poseidon_cuda.sponge_limbs(torch.zeros((rows, 2, 8), dtype=i32), 2)
            k, h, i64 = 1_000, 3, torch.int64  # G = 3
            poseidon_cuda.verify_digits(
                torch.zeros((k, h), dtype=i32), torch.zeros((k, h, 1, 16), dtype=i64),
                torch.zeros((k, 16), dtype=i64), torch.zeros(16, dtype=i64), 2)
    return calls


def test_lanes_counters_count_each_launch_under_its_g(monkeypatch):
    calls = _fake_launches(monkeypatch)
    before = trace.totals()
    calls()  # no session: nothing recorded
    assert trace.totals() == before
    with session():
        calls()
    c = trace.totals()["counters"]
    lanes = {k: v for k, v in c.items() if ".lanes." in k}
    assert lanes == {"k1.lanes.3": 1, "k1.lanes.1": 2, "k3.lanes.3": 1}
    assert c["launch.sponge"] == 3 and c["launch.verify"] == 1


def test_launches_metric_reads_the_same_launches_beside_the_lanes_counters(
        monkeypatch):
    from zkbench.metrics import launches

    calls = _fake_launches(monkeypatch)
    with session():
        calls()
        calls()
    assert trace.totals()["counters"]["k1.lanes.1"] == 4
    # 3 K1 launches and 1 K3 launch a request, whatever G each took.
    assert launches.read(types.SimpleNamespace(requests=2)) == 4.0


def test_digit_form_launches_count_beside_their_lanes(monkeypatch):
    """K1's digit form counts ``k1.input.digits`` a launch beside its G and
    its ``launch.sponge``; the limb form does not count it."""
    _fake_launches(monkeypatch)
    i64 = torch.int64
    with session():
        with trace.span("root"):
            poseidon_cuda.sponge_digits(torch.zeros((64, 8, 16), dtype=i64), 3)
            poseidon_cuda.sponge_digits(
                torch.zeros((65_536, 2, 16), dtype=i64), 3)
            poseidon_cuda.sponge_limbs(
                torch.zeros((64, 2, 8), dtype=torch.int32), 2)
    c = trace.totals()["counters"]
    assert c["k1.input.digits"] == 2
    assert c["k1.lanes.3"] == 2 and c["k1.lanes.1"] == 1
    assert c["launch.sponge"] == 3


def test_digit_form_verify_launches_count_beside_their_lanes(monkeypatch):
    """K3 counts each launch under its G and in ``launch.verify``.  Int32
    positions reach the launch as they are; int64 ones are clamped to
    [-1, arity] first, so 2^32 + p does not alias p in the cast."""
    _fake_launches(monkeypatch)
    seen = []
    monkeypatch.setattr(
        poseidon_cuda, "_check_limbs",
        lambda t, name, *a: seen.append(t) if name == "positions" else None)
    i32, i64 = torch.int32, torch.int64
    k, h = 1_000, 3  # G = 3
    pos32 = torch.zeros((k, h), dtype=i32)
    pos64 = torch.zeros((k, h), dtype=i64)
    pos64[0] = torch.tensor([5, -7, (1 << 32) + 1])
    digits = (torch.zeros((k, h, 3, 16), dtype=i64),
              torch.zeros((k, 16), dtype=i64), torch.zeros(16, dtype=i64))
    with session():
        with trace.span("root"):
            poseidon_cuda.verify_digits(pos32, *digits, 4)
            poseidon_cuda.verify_digits(pos64, *digits, 4)
            poseidon_cuda.verify_digits(pos32, *digits, 4)
    c = trace.totals()["counters"]
    assert c["k3.lanes.3"] == 3 and c["launch.verify"] == 3
    assert seen[0] is pos32 and seen[2] is pos32
    assert seen[1].dtype == i32 and seen[1][0].tolist() == [4, -1, 4]
    assert not seen[1][1:].any()


def test_conversions_count_their_rows_only_while_recording():
    from cuzk_tpu_torch.field import fr

    d = torch.zeros((3, 5, 16), dtype=torch.int64)
    before = trace.totals()
    fr.limbs_to_digits(fr.digits_to_limbs(d))
    assert trace.totals() == before
    with session():
        limbs = fr.digits_to_limbs(d)
        fr.limbs_to_digits(limbs[:2])
        fr.digits_to_limbs(d[0, 0])
    c = trace.totals()["counters"]
    assert fr.ROW_COUNTERS == ("convert.rows.to_limbs", "convert.rows.to_digits")
    assert c["convert.rows.to_limbs"] == 16 and c["convert.rows.to_digits"] == 10


def test_converted_rows_metric_reads_the_counters_a_request_and_row(
        monkeypatch):
    """40 rows converted a request of 160 rows is 25%; no rows of work, no
    root span, or a program that names no row counters (the port before
    it counted them) reads None."""
    from cuzk_tpu_torch.field import fr
    from zkbench.metrics import converted_rows

    with session():
        for _ in range(2):
            with trace.span("root"):
                trace.count("convert.rows.to_digits", 30)
                trace.count("convert.rows.to_limbs", 10)
                trace.count("k1.input.digits")
    view = types.SimpleNamespace(requests=2, work={"rows": 160})
    assert converted_rows.read(view) == 25.0
    assert converted_rows.read(types.SimpleNamespace(requests=2, work={})) is None
    monkeypatch.delattr(fr, "ROW_COUNTERS")
    assert converted_rows.read(view) is None
    monkeypatch.undo()
    with session():
        trace.count("convert.rows.to_digits", 30)
    assert converted_rows.read(view) is None


def _tree():
    g = torch.Generator().manual_seed(5)
    leaves = torch.randint(0, 1 << 16, (40, 16), generator=g)
    return leaves, merkle.build_tree_levels(leaves, 4)


def test_build_tree_levels_is_one_root_span_a_call():
    leaves, _ = _tree()
    with session():
        for _ in range(2):
            merkle.build_tree_levels(leaves, 4)
    t = trace.totals()
    r = rows(t)
    assert t["requests"] == 2
    assert r[("cuzk.build_tree_levels", None)]["count"] == 2
    assert r[("cuzk.build.pad", "cuzk.build_tree_levels")]["count"] == 2
    assert {parent for _, parent in r} == {None, "cuzk.build_tree_levels"}
    assert t["root_s"] == r[("cuzk.build_tree_levels", None)]["total_s"]


@pytest.mark.parametrize("dedupe,route", [(False, "exact"), (True, "dedup")])
def test_verify_each_is_one_root_span_and_one_route(dedupe, route):
    leaves, levels = _tree()
    idx = torch.tensor([0, 3, 17, 39])
    pos, sib = merkle.generate_proofs(levels, 4, idx)
    with session():
        got = merkle.verify_each(pos, sib, leaves[idx], levels[-1][0], 4,
                                 dedupe=dedupe)
    assert got.all()
    t = trace.totals()
    r = rows(t)
    assert t["requests"] == 1
    assert r[("cuzk.verify_each", None)]["count"] == 1
    routes = {k: v for k, v in t["counters"].items()
              if k.startswith("verify.route.")}
    assert routes == {f"verify.route.{route}": 1}


CELLS = {"semaphore-d20.commit": "commit",
         "cuzk-a4-50k.commit": "small_commit",
         "cuzk-a4-50k.verify": "verify",
         "filecoin-32g-rlast.commit": "commit"}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_traced_tiny_cell_reads_the_ports_host_time(name, tmp_path):
    from zkbench import run
    from zkbench.tests.conftest import make_tiny_root

    root = str(tmp_path)
    bench = make_tiny_root(root)
    cell = run.load_cell(name, bench, root)
    r = run.run_cell(cell, SEED, 0.01, True, "cpu", time.perf_counter())
    assert r["correct"], r["checks"]
    suffix = CELLS[name]
    assert r["metrics"][f"host_ms.{suffix}"]["value"] > 0
    # The plain path on the CPU launches no kernel.
    assert r["metrics"][f"launches.{suffix}"]["value"] == 0
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        listed = {m["name"] for m in json.load(fh)["per_layer"]
                  if name in m.get("workloads", [])}
    assert {f"host_ms.{suffix}", f"launches.{suffix}"} <= listed
    # Nor does it convert digits to limbs or back.
    if f"converted_rows.{suffix}" in listed:
        assert r["metrics"][f"converted_rows.{suffix}"]["value"] == 0
