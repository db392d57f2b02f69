"""The flight-bundle replay of the port
(``cloudberry_tpu_torch/tools/flight_replay.py``) against the JAX
package's ``tools/flight_replay.py``, on the CPU — the case of
``tests/test_capacity_forensics.py::test_flight_replay_bit_identical``.

A bundle carries a sha256 over the decoded result columns. The store
format and the digest are shared, so a bundle either engine captured
replays in the other over the same store to the same digest (integer,
DECIMAL and COUNT columns); a bundle captured at 8 segments records 8 in
both engines and replays at 8; ``main`` answers 0 on a bit-identical
replay, 1 on a mismatch and 2 on an unreplayable bundle."""

import json

import pytest

from tools import flight_replay as JFR
from cloudberry_tpu_torch.tools import flight_replay as TFR

Q = ("select k % 7 as g, count(*) as c, sum(v) as sv, sum(d) as sd "
     "from ft where k < 400 group by k % 7 order by g")


def _slow_session(engine, root, nseg=1):
    over = {"storage.root": root, "obs.slow_ms": 0.01}
    if engine == "port":
        from cloudberry_tpu_torch import Session
        from cloudberry_tpu_torch.config import Config

        s = Session(Config(n_segments=nseg).with_overrides(**over),
                    device="cpu")
    else:
        import cloudberry_tpu as cb
        from cloudberry_tpu.config import Config

        s = cb.Session(Config(n_segments=nseg).with_overrides(**over))
    return s


def _load(s):
    s.sql("create table ft (k bigint, v bigint, d decimal(12,2)) "
          "distributed by (k)")
    s.sql("insert into ft values " + ",".join(
        f"({i},{i * 3},{i}.{i % 100:02d})" for i in range(500)))


def _bundle(s, sql=Q):
    s.sql(sql)
    return next(b for b in s.stmt_log.flights(10)
                if b.get("replayable") and b["sql"] == sql)


def test_port_bundle_replays_bit_identically(tmp_path, capsys):
    """A bundle the port captured replays on a fresh port session over
    the same store (library call and CLI), and a later commit breaks
    the replay loudly."""
    s = _slow_session("port", str(tmp_path / "store"))
    _load(s)
    bundle = _bundle(s)
    verdict = TFR.replay(bundle, device="cpu")
    assert verdict["ok"], verdict
    assert verdict["got"]["columns"] == ["c", "g", "sd", "sv"]
    p = tmp_path / "flights.json"
    p.write_text(json.dumps({"flights": s.stmt_log.flights(10)}))
    idx = s.stmt_log.flights(10).index(bundle)
    assert TFR.main([str(p), "--index", str(idx), "--device", "cpu"]) == 0
    assert "OK: bit-identical replay (7 rows" in capsys.readouterr().out
    s.sql("insert into ft values (7, 999999, 1.00)")
    assert not TFR.replay(bundle, device="cpu")["ok"]
    assert TFR.main([str(p), "--index", str(idx), "--device", "cpu"]) == 1
    assert "MISMATCH" in capsys.readouterr().err


@pytest.mark.parametrize("captured,replayed", [("jax", "port"),
                                               ("port", "jax")])
def test_bundle_replays_across_engines(tmp_path, captured, replayed):
    """One store, written by the capturing engine: its bundle replays in
    the other engine to the same sha256, and both engines' bundles for
    the statement carry the same digest."""
    root = str(tmp_path / "store")
    s = _slow_session(captured, root)
    _load(s)
    bundle = _bundle(s)
    if replayed == "port":
        verdict = TFR.replay(bundle, device="cpu")
    else:
        verdict = JFR.replay(bundle)
    assert verdict["ok"], verdict
    other = _bundle(_slow_session(replayed, root))
    assert other["result"] == bundle["result"]
    assert bundle["result"]["rows"] == 7


def test_bundle_records_the_segment_count(tmp_path):
    """At 8 segments both engines record ``n_segments`` 8 in the bundle
    (the port once recorded 1 whatever it ran), and the replay opens its
    session at 8 segments: the digest matches."""
    bundles = {}
    for engine in ("jax", "port"):
        s = _slow_session(engine, str(tmp_path / engine), nseg=8)
        _load(s)
        bundles[engine] = _bundle(s)
    assert bundles["port"]["n_segments"] == bundles["jax"]["n_segments"] == 8
    assert bundles["port"]["result"] == bundles["jax"]["result"]
    seen = []
    from cloudberry_tpu_torch import session as TS

    real = TS.Session.__init__

    def spy(self, config=None, device=None):
        seen.append(config.n_segments)
        real(self, config, device)

    TS.Session.__init__ = spy
    try:
        verdict = TFR.replay(bundles["port"], device="cpu")
    finally:
        TS.Session.__init__ = real
    assert verdict["ok"], verdict
    assert seen == [8]


def test_exit_codes(tmp_path, capsys):
    """0 on a bit-identical replay, 1 on a mismatch, 2 on an unreplayable
    bundle (no store root, or no result digest) — as the JAX package's
    tool answers the same files."""
    root = str(tmp_path / "store")
    s = _slow_session("port", root)
    _load(s)
    ok = _bundle(s)
    with pytest.raises(Exception):
        s.sql("select nope from ft")
    errored = s.stmt_log.flights(1)[0]
    mem = _slow_session("port", "")
    mem.sql("create table m (x bigint)")
    mem.sql("insert into m values (1), (2)")
    no_root = _bundle(mem, "select sum(x) as s from m")
    assert no_root["storage_root"] in (None, "")
    bad = dict(ok, result=dict(ok["result"], sha256="0" * 64))
    codes = {}
    for name, b in (("ok", ok), ("mismatch", bad), ("errored", errored),
                    ("no_root", no_root)):
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps(b))
        codes[name] = (JFR.main([str(p)]),
                       TFR.main([str(p), "--device", "cpu"]))
        capsys.readouterr()
    assert codes == {"ok": (0, 0), "mismatch": (1, 1), "errored": (2, 2),
                     "no_root": (2, 2)}
    assert TFR.pick_bundle([ok, bad], 1) is bad
    assert TFR.pick_bundle({"meta": {"flights": [ok]}}) is ok
    with pytest.raises(ValueError):
        TFR.pick_bundle([])
