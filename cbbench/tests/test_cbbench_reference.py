"""Each reference template against the program's CPU ``Session`` on the
same encoded data, at a small scale: the validation parameters and some
drawn ones; and the comparison and its control."""

import importlib

import pytest

from cbbench import check, traffic
from cbbench.gen import tpch
from cbbench.reference.common import DB

FAMILIES = {"tpch": (tpch, 0.01, "streams3")}


def _session(made):
    import cloudberry_tpu_torch as cb
    from cloudberry_tpu_torch.catalog.carry import field, load_encoded

    s = cb.Session(device="cpu")
    for name, h in made.items():
        load_encoded(s, name, [field(n, b, sc) for n, b, sc in h.fields],
                     h.columns, dict_values=h.dicts)
    return s


def _wire(session, sql):
    from cloudberry_tpu_torch.serve.server import Server

    return Server._render(None, session.sql(sql))["rows"]


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    gen, scale, mix_name = FAMILIES[request.param]
    mix = traffic.load_mix(mix_name)
    templates = traffic.load_templates(request.param, mix["templates"])
    tables = sorted({t for x in templates.values() for t in x["tables"]})
    host = {k: v.to_host()
            for k, v in gen.make(scale, 2**31 + 3, "cpu", tables).items()}
    return request.param, mix, templates, host, _session(host)


def test_every_template_equals_the_program(family):
    name, mix, templates, host, session = family
    db = DB(host, "cpu")
    tr = traffic.Traffic(mix, templates, 17)
    stmts = list(tr.warmup())
    if mix["params"] == "drawn":
        it = tr.client(0)
        stmts += [next(it) for _ in range(3 * len(templates))]
    for st in stmts:
        ref = importlib.import_module(
            f"cbbench.reference.{name}.{st.template}").answer(
            db, dict(st.params))
        gaps = check.compare(ref, _wire(session, st.sql(templates)))
        assert gaps.correct(), (st, gaps)


def test_a_changed_cell_or_row_is_caught(family):
    name, mix, templates, host, session = family
    db = DB(host, "cpu")
    for st in traffic.Traffic(mix, templates, 1).warmup():
        ref = importlib.import_module(
            f"cbbench.reference.{name}.{st.template}").answer(
            db, dict(st.params))
        rows = _wire(session, st.sql(templates))
        if not rows:
            continue
        bad = [list(r) for r in rows]
        col = next(i for i, k in enumerate(ref.kinds) if k == "x")
        v = bad[0][col]
        bad[0][col] = v + 1 if isinstance(v, (int, float)) else v + "x"
        assert check.compare(ref, bad).wrong_cells >= 1, st
        assert check.compare(ref, rows[:-1]).wrong_cells >= 1, st
        assert check.compare(ref, rows + rows[:1]).wrong_cells >= 1, st


@pytest.mark.parametrize("mode", ["float64", "float32"])
@pytest.mark.parametrize("cell,scale", [("tpch_sf10.power", 0.01),
                                        ("tpch_sf10.streams3", 0.01)])
def test_the_control_is_not_correct(cell, scale, mode):
    from cbbench.control import control_gaps

    gaps = control_gaps(cell, 2**31 + 5, mode, "cpu", scale=scale)
    assert gaps.checked >= 7
    assert not gaps.correct()


def test_ties_at_the_limit_take_any_of_the_tied_rows():
    from cbbench.reference.common import Result

    ref = Result([[1, "a"], [1, "b"], [1, "c"], [0, "d"]], ["x", "x"],
                 [0], 2)
    assert check.compare(ref, [[1, "c"], [1, "a"]]).correct()
    assert not check.compare(ref, [[1, "a"], [0, "d"]]).correct()
    flt = Result([[1.0, 2.0]], ["x", "f"], [], None)
    assert check.compare(flt, [[1.0, 2.0 * (1 + 1e-15)]]).correct()
    assert not check.compare(flt, [[1.0, 2.0 * (1 + 1e-9)]]).correct()
