"""The store fsck and orphan GC (storage/fsck.py, ``mgmt fsck``) through
the port against the JAX package, on the CPU — the fsck cases of
``tests/test_iofault.py``.

The store format is shared, so each case writes one store (with the
port, or with the JAX package where the case says so), damages it the
way the reference's case does, and runs both engines' ``fsck`` over the
same bytes at the same ``now``: the reports must be equal (``tables``,
``problems``, ``orphans``, ``collected``, ``census_skipped`` and the
verdict; every orphan's ``age_s`` left out). A case that collects
garbage runs each engine's fsck on its own copy of the damaged store
(``shutil.copytree`` keeps the files' times). The CLI's text and
``--json`` output are compared the same way."""

import json
import os
import re
import shutil
import time

import pytest

from torch_parity import chaos_teardown

NOW_AHEAD = 10.0   # fsck's clock: the store's files are this old


@pytest.fixture(autouse=True)
def _clean_faults():
    from cloudberry_tpu.storage import iofault as JIO
    from cloudberry_tpu_torch.storage import iofault as TIO

    chaos_teardown()
    JIO.reset_counters()
    TIO.reset_counters()
    yield
    chaos_teardown()
    JIO.reset_counters()
    TIO.reset_counters()


def _session(root, writer="port"):
    if writer == "port":
        from cloudberry_tpu_torch import Session
        from cloudberry_tpu_torch.config import Config

        return Session(Config().with_overrides(**{"storage.root": root}),
                       device="cpu")
    import cloudberry_tpu as cb
    from cloudberry_tpu.config import Config

    return cb.Session(Config().with_overrides(**{"storage.root": root}))


def _insert(s, n0=0, n=4):
    s.sql("create table t (k bigint, v bigint) distributed by (k)")
    vals = ", ".join(f"({k}, {k * 7})" for k in range(n0, n0 + n))
    s.sql(f"insert into t values {vals}")


def _FI(writer):
    import importlib

    pkg = "cloudberry_tpu_torch" if writer == "port" else "cloudberry_tpu"
    return importlib.import_module(f"{pkg}.utils.faultinject")


def _IO(writer):
    import importlib

    pkg = "cloudberry_tpu_torch" if writer == "port" else "cloudberry_tpu"
    return importlib.import_module(f"{pkg}.storage.iofault")


def _stable(rep: dict) -> dict:
    out = {k: v for k, v in rep.items() if k != "root"}
    out["orphans"] = [{k: v for k, v in o.items() if k != "age_s"}
                      for o in rep["orphans"]]
    return out


def both_fsck(root, now, copies=False, **kw) -> dict:
    """The JAX package's and the port's fsck over ``root`` (over a copy
    each when ``copies``: GC unlinks), held equal; returns the port's
    report."""
    from cloudberry_tpu.storage.fsck import fsck as jfsck
    from cloudberry_tpu_torch.storage.fsck import fsck as tfsck

    jroot = troot = root
    if copies:
        jroot, troot = root + "-jax", root + "-port"
        for r in (jroot, troot):
            shutil.rmtree(r, ignore_errors=True)
            shutil.copytree(root, r)
    want = jfsck(jroot, now=now, **kw)
    got = tfsck(troot, now=now, **kw)
    assert _stable(got) == _stable(want)
    return got


# --------------------------------------------------------- damage cases


def _torn_manifest(root, writer):
    FI = _FI(writer)
    s = _session(root, writer)
    _insert(s)
    FI.inject_fault("io_manifest_write", "torn")
    with pytest.raises(Exception, match="torn|IO|write"):
        s.sql("insert into t values (100, 700)")
    FI.reset_fault()


def _dropped_fsync(root, writer):
    FI, IO = _FI(writer), _IO(writer)
    s = _session(root, writer)
    _insert(s)
    FI.inject_fault("io_partition_write", "fsync_drop")
    s.sql("insert into t values (100, 700)")
    FI.reset_fault()
    assert len(IO.simulated_crash()) == 1


def _first_part(root):
    return next(f for f in sorted(os.listdir(os.path.join(root, "t")))
                if f.endswith(".cbmp"))


def _bit_flip(root, writer):
    from cloudberry_tpu_torch.storage import micropartition as mp

    _insert(_session(root, writer), n=8)
    path = os.path.join(root, "t", _first_part(root))
    raw = bytearray(open(path, "rb").read())
    raw[len(mp.MAGIC) + 3] ^= 0x40
    open(path, "wb").write(bytes(raw))


def _unknown_cksum(root, writer):
    _insert(_session(root, writer), n=8)
    path = os.path.join(root, "t", _first_part(root))
    raw = open(path, "rb").read()
    idx = raw.rindex(b"crc32:")
    open(path, "wb").write(raw[:idx] + b"crc99:" + raw[idx + 6:])


def _torn_current(root, writer):
    _insert(_session(root, writer))
    mdir = os.path.join(root, "t", "_manifests")
    with open(os.path.join(mdir, "CURRENT")) as f:
        v = f.read().strip()
    mpath = os.path.join(mdir, f"v{v}.json")
    raw = open(mpath, "rb").read()
    open(mpath, "wb").write(raw[:len(raw) // 2])


def _missing_and_stray(root, writer):
    _insert(_session(root, writer))
    os.unlink(os.path.join(root, "t", _first_part(root)))
    open(os.path.join(root, "t", "part-deadbeef.cbmp"), "wb").write(
        b"unreferenced")


def _dv_out_of_range(root, writer):
    from cloudberry_tpu_torch.storage.table_store import TableStore

    _insert(_session(root, writer))
    store = TableStore(root)
    man = store.read_manifest("t")
    man["partitions"][0]["deleted"] = [10_000]
    with store.lock():
        store._commit("t", man)


def _journal_pending(root, writer):
    _insert(_session(root, writer))
    open(os.path.join(root, "t", "part-pending.cbmp"), "wb").write(
        b"replacement-in-flight")
    open(os.path.join(root, "t", "part-deadbeef.cbmp"), "wb").write(
        b"not a partition")
    with open(os.path.join(root, "_COMPACTION.json"), "w") as f:
        json.dump({"counters": {}, "pending":
                   {"table": "t", "files": ["part-pending.cbmp"]}}, f)


def _torn_journal(root, writer):
    _insert(_session(root, writer))
    open(os.path.join(root, "t", "part-deadbeef.cbmp"), "wb").write(b"x")
    open(os.path.join(root, "_COMPACTION.json"), "w").write('{"pend')


def _stale_tmp(root, writer):
    _insert(_session(root, writer))
    open(os.path.join(root, "tmpabc123"), "w").write("{")
    open(os.path.join(root, "t", "_manifests", "tmpxyz"), "w").write("{")
    open(os.path.join(root, "t", "_manifests", "v99.json"), "w").write("{")


CASES = {
    # name: (writer, damage, fsck kwargs, clean?)
    "clean_deep": ("port", lambda r, w: _insert(_session(r, w)),
                   {"deep": True}, True),
    "clean_jax_store": ("jax", lambda r, w: _insert(_session(r, w)),
                        {"deep": True}, True),
    "torn_manifest_write": ("port", _torn_manifest, {"deep": True}, True),
    "dropped_fsync": ("port", _dropped_fsync, {"deep": True}, False),
    "bit_flip": ("jax", _bit_flip, {"deep": True}, False),
    "unknown_cksum_algo": ("port", _unknown_cksum, {"deep": True}, False),
    "torn_current_gc": ("port", _torn_current,
                        {"grace_s": 0.0, "gc": True}, False),
    "census_skipped_gc": ("jax", _missing_and_stray,
                          {"grace_s": 0.0, "gc": True}, False),
    "dv_out_of_range": ("port", _dv_out_of_range, {}, False),
    "journal_pending_gc": ("port", _journal_pending,
                           {"grace_s": 0.0, "gc": True}, True),
    "torn_journal_gc": ("jax", _torn_journal,
                        {"grace_s": 0.0, "gc": True}, False),
    "stale_tmp_gc": ("port", _stale_tmp, {"grace_s": 0.0, "gc": True},
                     True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fsck_report_equals_jax(tmp_path, case):
    writer, damage, kw, clean = CASES[case]
    root = str(tmp_path / "store")
    damage(root, writer)
    rep = both_fsck(root, time.time() + NOW_AHEAD,
                    copies=kw.get("gc", False), **kw)
    assert rep["clean"] is clean, rep["problems"]


def test_fsck_orphans_grace_and_gc(tmp_path):
    """A young orphan is reported and protected by the grace window; past
    it, GC collects it; both engines alike at every step."""
    root = str(tmp_path / "store")
    _insert(_session(root))
    open(os.path.join(root, "t", "part-deadbeef.cbmp"), "wb").write(
        b"not a partition")
    now = time.time() + NOW_AHEAD
    rep = both_fsck(root, now, copies=True, grace_s=3600.0, gc=True)
    assert rep["clean"] and rep["collected"] == []
    assert rep["orphans"] == [{"path": "t/part-deadbeef.cbmp",
                               "age_s": rep["orphans"][0]["age_s"],
                               "collectable": False}]
    rep = both_fsck(root, now, copies=True, grace_s=0.0, gc=True)
    assert rep["collected"] == ["t/part-deadbeef.cbmp"]
    from cloudberry_tpu_torch.storage.fsck import fsck

    fsck(root, grace_s=0.0, gc=True, now=now)
    assert both_fsck(root, now)["orphans"] == []


def test_footer_checksums_survive_compaction(tmp_path):
    """The port's compaction writes footers every engine verifies."""
    from cloudberry_tpu.storage import micropartition as jmp
    from cloudberry_tpu_torch.storage import micropartition as tmp
    from cloudberry_tpu_torch.storage.compact import CompactionService

    root = str(tmp_path / "store")
    s = _session(root)
    _insert(s)
    s.sql("insert into t values (50, 350)")
    CompactionService(s).run_once(force=True)
    for f in os.listdir(os.path.join(root, "t")):
        if f.endswith(".cbmp"):
            path = os.path.join(root, "t", f)
            assert all("cksum" in c for c in tmp.read_footer(path)["columns"])
            assert tmp.verify_file(path) == jmp.verify_file(path) == []
    assert both_fsck(root, time.time(), deep=True)["clean"]


# ---------------------------------------------------------------- the CLI


_AGE = re.compile(r"age [0-9.]+s")


def _cli_both(capsys, root, *argv):
    from cloudberry_tpu.mgmt import cli as JC
    from cloudberry_tpu_torch.mgmt import cli as TC

    outs = []
    for main in (JC.main, TC.main):
        rc = main(["--store", root, "fsck", *argv])
        outs += [rc, capsys.readouterr().out]
    return outs


def test_cli_fsck_text_and_json(tmp_path, capsys):
    root = str(tmp_path / "store")
    _insert(_session(root))
    jr, jo, tr, to = _cli_both(capsys, root, "--deep")
    assert (jr, tr) == (0, 0) and jo == to
    assert "table t: v3, 1 partitions, 4 live rows, 1 deep-checked" in to
    assert to.endswith("fsck clean: 0 problem(s), 0 orphan(s), "
                       "0 collected\n")
    open(os.path.join(root, "t", "part-deadbeef.cbmp"), "wb").write(b"x")
    _dv_out_of_range(str(tmp_path / "other"), "port")
    jr, jo, tr, to = _cli_both(capsys, root)
    assert (jr, tr) == (0, 0) and _AGE.sub("", jo) == _AGE.sub("", to)
    assert "orphan t/part-deadbeef.cbmp" in to
    jr, jo, tr, to = _cli_both(capsys, str(tmp_path / "other"), "--json")
    assert (jr, tr) == (1, 1)
    assert _stable(json.loads(to)) == _stable(json.loads(jo))
    assert "out of range" in json.loads(to)["problems"][0]
