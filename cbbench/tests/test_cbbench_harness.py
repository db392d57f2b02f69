"""The harness driven on the CPU at a tiny scale, past its look for a
card: a sound run is correct, and a run whose answers are broken where
the server produces them is not."""

import pytest

from cbbench import bench

CELLS = [("tpch_sf10.power", 0.01), ("tpch_sf10.streams3", 0.01)]


def _run(cell, scale, traced=False):
    return bench.run_cell(cell, 2**31 + 11, 1.0, traced, device="cpu",
                          scale=scale, log=lambda *a, **k: None)


@pytest.mark.parametrize("cell,scale", CELLS)
def test_a_sound_run_is_correct(cell, scale):
    out = _run(cell, scale)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # no card: no metric is read
    assert out["metrics"] == {}


def _broken(monkeypatch, how):
    from cloudberry_tpu_torch.serve import server

    render = server.Server._render

    def broken(self, result):
        resp = render(self, result)
        rows = resp.get("rows")
        if rows:
            if how == "altered":
                r = list(rows[0])
                r[0] = r[0] + "?" if isinstance(r[0], str) else r[0] + 1
                rows[0] = r
            elif how == "half":
                del rows[len(rows) // 2:]
                resp["rowcount"] = len(rows)
        return resp

    monkeypatch.setattr(server.Server, "_render", broken)


@pytest.mark.parametrize("how", ["altered", "half"])
@pytest.mark.parametrize("cell,scale", CELLS)
def test_a_broken_answer_is_not_correct(monkeypatch, cell, scale, how):
    _broken(monkeypatch, how)
    out = _run(cell, scale)
    assert not out["correct"]
    assert out["compared"]["wrong_cells"]["value"] > 0


def test_a_failed_statement_is_not_correct(monkeypatch):
    from cloudberry_tpu_torch.serve import server

    execute = server.Server._execute
    calls = {"n": 0}

    def failing(self, req, sess, async_cb=None):
        calls["n"] += 1
        if calls["n"] == 20:  # the window's fourth statement
            raise RuntimeError("injected")
        return execute(self, req, sess, async_cb)

    monkeypatch.setattr(server.Server, "_execute", failing)
    out = _run("tpch_sf10.power", 0.01)
    assert out["failed"] == 1
    assert not out["correct"]


def test_the_traced_run_reads_nothing_without_a_card():
    out = _run("tpch_sf10.power", 0.01, traced=True)
    assert out["correct"]
    assert out["metrics"] == {}
    assert out["device"]["busy_s"] is None


@pytest.mark.card
def test_a_run_on_the_card(card):
    out = bench.run_cell("tpch_sf10.power", 5, 2.0, True, device=card,
                         scale=0.1, log=lambda *a, **k: None)
    assert out["correct"]
    assert out["device"]["busy_s"] > 0
    assert 0 <= out["metrics"]["device_idle_pct"]["value"] <= 100
