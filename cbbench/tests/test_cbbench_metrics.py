"""The roofline byte counts against hand sums for known shapes, every
metric reader's silence without a card, the readers of the window on a
made-up window, and the imports of the benchmark's modules."""

import ast
import math
from pathlib import Path

import pytest
import torch

from cbbench import bench
from cbbench.metrics import _roofline

HERE = Path(__file__).resolve().parent.parent


def test_dense_agg_bytes():
    n, cells = 1000, 6
    sel = torch.zeros(n, dtype=torch.bool)
    sel[:250] = True
    b = _roofline.dense_agg_bytes(torch.zeros(n, dtype=torch.int32),
                                  torch.zeros((3, n), dtype=torch.int64),
                                  torch.zeros((2, n)), sel, cells)
    # sel for every row; gid and 5 value rows for 250 kept rows; 6 x 6 out
    assert b.resolve() == n + 250 * (4 + 5 * 8) + (1 + 5) * cells * 8


def test_sorted_seg_bytes():
    vals = torch.zeros((2, 100), dtype=torch.int64)
    starts = torch.tensor([0, 10, 50, 0, 0], dtype=torch.int64)
    ends = torch.tensor([9, 39, 59, 0, 0], dtype=torch.int64)
    b = _roofline.sorted_seg_bytes(vals, starts, ends, torch.tensor(3), 5)
    rows = 10 + 30 + 10
    assert b.resolve() == 8 + 3 * 16 + rows * 2 * 8 + (1 + 2) * 5 * 8


def test_probe_join_bytes():
    bkeys = [torch.zeros(20, dtype=torch.int64),
             torch.zeros(20, dtype=torch.int32)]
    pkeys = [torch.zeros(500, dtype=torch.int64),
             torch.zeros(500, dtype=torch.int32)]
    psel = torch.zeros(500, dtype=torch.bool)
    psel[::5] = True
    payload = [torch.zeros(20, dtype=torch.int32)]
    b = _roofline.probe_join_bytes(bkeys, torch.ones(20, dtype=torch.bool),
                                   pkeys, psel, payload,
                                   torch.zeros(1, dtype=torch.int32))
    assert b.resolve() == (20 * (1 + 12 + 4) + 500 * (2 + 4) + 4
                           + 100 * 12)


def _all_metric_names():
    spec = bench.load_spec()
    return [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]


class _Tracer:
    on_card = False
    device_ops = []
    window_s = busy_s = None
    launches = {"dense_agg": [1], "sorted_seg": [1], "probe_join": [1]}
    counters = {"stmt_cache_hits": 1}

    def statements(self):
        return [{"t0": 0.0, "t1": 0.01, "sql": "select 1",
                 "spans": {"launch": 0.01}}]

    def kernel_seconds(self, k):
        return 1.0


def _window():
    w = bench.Window(0.0, 10.0)
    st = bench.traffic.Statement("q1", ())
    w.requests = [bench.Request(0, st, "select 1", float(i), float(i) + 0.1,
                                rows=[]) for i in range(9)]
    return w


@pytest.mark.parametrize("name", _all_metric_names())
def test_every_reader_reads_nothing_without_a_card(name):
    ctx = bench.Context("tpch_sf10.power", _window(), 1.0, _Tracer(),
                        on_card=False)
    assert bench.reader(name)(ctx) is None


def test_window_readers_on_a_made_up_window():
    w = _window()
    w.requests[-1].t_recv = 11.0  # sent at 8 s, answered after the close
    ctx = bench.Context("c", w, 2.5, None, on_card=True)
    # the rate counts what answered within the window; the latencies
    # count the late statement too, with its whole wait
    assert bench.reader("qps")(ctx) == pytest.approx(0.8)
    assert bench.reader("geomean_ms")(ctx) == pytest.approx(
        math.exp((8 * math.log(100.0) + math.log(3000.0)) / 9))
    assert bench.reader("p95_ms")(ctx) == pytest.approx(100 + 0.6 * 2900)
    assert bench.reader("p95_ms.tpch_sf10.streams3")(ctx) == \
        pytest.approx(100 + 0.6 * 2900)
    assert bench.reader("setup_s")(ctx) == 2.5


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            assert mod.split(".", 1)[0] not in (
                "jax", "jaxlib", "flax", "cloudberry_tpu"), (f, mod)


def test_the_reference_and_generators_import_nothing_of_the_program():
    for sub in ("reference", "gen"):
        for f in sorted((HERE / sub).rglob("*.py")):
            for mod in _imports(f):
                assert mod.split(".", 1)[0] != "cloudberry_tpu_torch", \
                    (f, mod)


def test_benchmark_json_keeps_the_contract():
    spec = bench.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            assert c in cells
            mv = e2e[m["moves"]]
            assert c in mv.get("workloads", cells), (m["name"], c)
    for w in spec["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    for c in spec["configs"]:
        assert (HERE.parent / c["file"]).exists()
    for n in names:
        assert bench.reader(n) is not None
    assert not math.isnan(spec["run_seconds"])
