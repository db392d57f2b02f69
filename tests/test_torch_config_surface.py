"""The port's configuration surface against the JAX package's: the port's
``Config`` has every field of the JAX package's but ``exec.use_pallas``
(which picks the JAX package's plain path over its kernels, a switch the
port does not have), and the six storage and scheduler keys the port once
pinned as constants (ROADMAP C 16) behave as in the JAX package:

- ``storage.quota_bytes``: a write at the quota raises ``QuotaError`` —
  INSERT, COPY FROM, a streaming append, over the wire with the JAX
  package's etype and retryable flag — while reads, DELETE and DROP still
  work, a refused INSERT leaves the table as it was, and DROP reclaims
  (``tests/test_availability.py``'s two quota cases among them);
- ``storage.verify_checksums``: off, a flipped bit inside a column blob
  decodes into the answer; on, it raises ``StorageCorruptionError``;
  ``fsck --deep`` verifies either way;
- ``storage.partition_selector_max_build``: 0 turns dynamic partition
  elimination off, with equal results;
- ``bufferpool.enabled``: off, no pool and equal results;
- ``sched.shared_cache``: off, every store-backed session's scope is
  private;
- ``sched.max_variants``: the generic-plan variants kept per skeleton.

Every scenario runs in both engines through ``torch_parity.twin`` (the
JAX package on CPU JAX, the port on the CPU) and holds each kept value
equal.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

import cloudberry_tpu.config as JC
import cloudberry_tpu_torch.config as TC
from torch_parity import twin, twin_servers

QUOTA = 20_000
TIMEOUT = 60

# the six keys and the JAX package's defaults
KEYS = {
    "storage.quota_bytes": 0,
    "storage.verify_checksums": True,
    "storage.partition_selector_max_build": 1 << 17,
    "bufferpool.enabled": True,
    "sched.shared_cache": True,
    "sched.max_variants": 4,
}


def _fields(cfg, prefix="") -> dict:
    """Every leaf field of a config tree by its dotted path."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, prefix + f.name + "."))
        else:
            out[prefix + f.name] = v
    return out


def test_the_port_has_every_jax_key_but_use_pallas():
    """The two trees differ by exactly ``exec.use_pallas``, so a key that
    the JAX package adds later fails here until the port has it."""
    jax, port = _fields(JC.Config()), _fields(TC.Config())
    assert set(jax) - set(port) == {"exec.use_pallas"}
    assert set(port) - set(jax) == set()


@pytest.mark.parametrize("key", sorted(KEYS))
def test_each_key_has_the_jax_default(key):
    assert _fields(TC.Config())[key] == _fields(JC.Config())[key] \
        == KEYS[key]


def test_only_generic_plans_keeps_another_default():
    """Every shared key has the JAX package's default but
    ``sched.generic_plans`` (ROADMAP C 30)."""
    jax, port = _fields(JC.Config()), _fields(TC.Config())
    differ = {k for k in port if port[k] != jax[k]}
    assert differ == {"sched.generic_plans"}


# ------------------------------------------------------------ disk quota


def _fill(s, table="q"):
    """``table`` with 8,192 incompressible int64 rows (random full-range
    values defeat the delta-varint and zstd encoders), past the quota."""
    s.sql(f"create table {table} (x bigint)")
    rng = np.random.default_rng(5)
    s.catalog.table(table).set_data(
        {"x": rng.integers(-(2**62), 2**62, 8192).astype(np.int64)}, {})
    # the quota check reads a usage cached for a few seconds (approximate
    # by design, as the diskquota worker's); refresh it past the fill
    assert s.store.disk_usage(fresh=True) >= QUOTA


def _refusal(e, fn, *args):
    """Run a write expected to be refused at the quota; keeps the error's
    type and its words (the byte count differs between the engines'
    manifests)."""
    try:
        fn(*args)
    except Exception as err:  # noqa: BLE001 — the type is compared
        msg = str(err)
        head, _, tail = msg.partition(" quota bytes;")
        return e.keep((type(err).__name__, head.split(":")[0], tail))
    raise AssertionError(f"{fn} was not refused")


def _count(s, table):
    return int(s.sql(f"select count(*) as c from {table}")
               .decoded_columns()["c"][0])


def test_disk_quota_blocks_writes_delete_reclaims(tmp_path):
    """``tests/test_availability.py``'s case: past the quota an INSERT
    and a COPY FROM raise ``QuotaError``, reads still answer, the refused
    INSERT leaves the rows as they were, and DROP reclaims, after which
    writes work again."""
    src = tmp_path / "one.txt"
    src.write_text("1\n2\n")

    def run(e):
        s = e.session(**{"storage.root": e.root(),
                         "storage.quota_bytes": QUOTA})
        _fill(s)
        _refusal(e, s.sql, "insert into q values (1)")
        _refusal(e, s.sql, f"copy q from '{src}'")
        e.keep(_count(s, "q"))
        e.keep(s.sql("select min(x) as lo, max(x) as hi from q"))
        s.sql("drop table q")
        s.sql("create table q2 (x bigint)")
        s.sql("insert into q2 values (1)")
        e.keep(_count(s, "q2"))
        e.keep(str(s.sql(f"copy q2 from '{src}'")))
        e.keep(_count(s, "q2"))
    got = twin(run, tmp_path)
    assert got[0] == ("QuotaError", "disk quota exceeded",
                      " writes to 'q' refused (DELETE / DROP TABLE to "
                      "reclaim)")
    assert got[1] == got[0] and got[2] == 8192
    assert got[4] == 1 and got[6] == 3


def test_delete_past_the_quota_unlike_jax(tmp_path):
    """Past the quota a SQL DELETE (which rewrites the table without the
    deleted rows) still runs in the port, as the refusal's own words
    ("DELETE / DROP TABLE to reclaim") and the JAX package's config
    promise; the JAX package refuses it with ``QuotaError`` (ROADMAP
    C 64). An UPDATE, a rewrite of as many rows, stays refused in both,
    and both leave the rows as they were after a refusal."""
    import cloudberry_tpu as cb
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu.storage.table_store import QuotaError as JQuota
    from cloudberry_tpu_torch.storage.table_store import QuotaError

    over = {"storage.quota_bytes": QUOTA}
    js = cb.Session(JC.Config().with_overrides(
        **{"storage.root": str(tmp_path / "jax"), **over}))
    ts = ct.Session(TC.Config().with_overrides(
        **{"storage.root": str(tmp_path / "port"), **over}), device="cpu")
    for s in (js, ts):
        _fill(s)
    x = np.random.default_rng(5).integers(-(2**62), 2**62, 8192)
    for s, err in ((js, JQuota), (ts, QuotaError)):
        with pytest.raises(err, match="disk quota exceeded"):
            s.sql("update q set x = x + 1 where x < 0")
        assert _count(s, "q") == 8192
    with pytest.raises(JQuota, match="disk quota exceeded"):
        js.sql("delete from q where x < 0")
    assert _count(js, "q") == 8192
    ts.sql("delete from q where x < 0")
    assert _count(ts, "q") == int((x >= 0).sum())
    assert sorted(ts.sql("select x from q").decoded_columns()["x"]
                  .tolist()) == sorted(x[x >= 0].tolist())
    fresh = ct.Session(TC.Config().with_overrides(
        **{"storage.root": str(tmp_path / "port"), **over}), device="cpu")
    assert _count(fresh, "q") == int((x >= 0).sum())
    with pytest.raises(QuotaError):
        fresh.sql("insert into q values (1)")


def test_quota_zero_is_unlimited(tmp_path):
    """``tests/test_availability.py``'s case: quota 0 refuses nothing."""
    def run(e):
        s = e.session(**{"storage.root": e.root()})
        e.keep(s.store.quota_bytes)
        s.sql("create table uq (x bigint)")
        s.catalog.table("uq").set_data(
            {"x": np.arange(100_000, dtype=np.int64)}, {})
        s.sql("insert into uq values (1)")
        e.keep(_count(s, "uq"))
    assert twin(run, tmp_path) == [0, 100_001]


def test_quota_refusal_over_the_wire_and_the_append_verb(tmp_path):
    """Over the wire the refusal carries the JAX package's etype and
    retryable flag, for an INSERT and for a streaming append; reads and
    DROP answer past the quota."""
    def run(e):
        cfg = e.config(**{"storage.root": e.root(),
                          "storage.quota_bytes": QUOTA,
                          "ingest.flush_rows": 1, "ingest.flush_ms": 5.0})
        boot = e.session(**{"storage.root": e.root()})
        _fill(boot)
        srv = e.server(config=cfg)
        c = e.client(srv, timeout=TIMEOUT)
        for call in ((c.sql, "insert into q values (1)"),
                     (c.append, "q", [[2]])):
            try:
                call[0](*call[1:])
                e.keep("accepted")
            except e.ServerError as err:
                e.keep((err.etype, err.retryable,
                        "disk quota exceeded" in str(err)))
        e.wire(c.sql, "select count(*) as c from q")
        e.wire(c.sql, "drop table q")
        e.wire(c.sql, "create table q3 (x bigint)")
        e.wire(c.append, "q3", [[3]])
    got = twin_servers(run, tmp_path)
    assert got[0] == ("QuotaError", False, True)
    assert got[1] == got[0]


def test_streaming_append_past_the_quota(tmp_path):
    """An ``IngestService`` append whose flush meets the quota fails with
    the same ``QuotaError``; the buffered rows are not committed."""
    def run(e):
        I = e.mod("storage.ingest")
        s = e.session(**{"storage.root": e.root(),
                         "storage.quota_bytes": QUOTA,
                         "ingest.flush_rows": 1, "ingest.flush_ms": 5.0})
        _fill(s)
        ing = I.IngestService(s)
        try:
            _refusal(e, ing.append, "q", [[1], [2]])
        finally:
            ing.stop()
        e.keep(_count(s, "q"))
    got = twin(run, tmp_path)
    assert got[0][0] == "QuotaError" and got[1] == 8192


# -------------------------------------------------------- content checksums


def _flipped_store(tmp_path) -> str:
    """One store written by the JAX package (the format is shared) whose
    ``v`` column blob has a bit flipped in its last byte: its last value
    decodes wrong unless the checksum is verified."""
    import cloudberry_tpu as cb
    from cloudberry_tpu.storage import micropartition as mp

    root = str(tmp_path / "flipped")
    s = cb.Session(JC.Config().with_overrides(**{"storage.root": root}))
    s.sql("create table t (k bigint, v bigint) distributed by (k)")
    s.sql("insert into t values " +
          ", ".join(f"({k}, {k * 7})" for k in range(8)))
    part = next(f for f in os.listdir(os.path.join(root, "t"))
                if f.endswith(".cbmp"))
    path = os.path.join(root, "t", part)
    col = next(c for c in mp.read_footer(path)["columns"]
               if c["name"] == "v")
    raw = bytearray(open(path, "rb").read())
    raw[col["offset"] + col["length"] - 1] ^= 0x40
    open(path, "wb").write(bytes(raw))
    return root


def test_verify_off_is_a_config_choice(tmp_path):
    """``tests/test_iofault.py``'s case: the key reaches the session's
    store, and a session opened without it verifies again."""
    def run(e):
        over = {"storage.root": e.root()}
        off = e.session(**over, **{"storage.verify_checksums": False})
        e.keep((off.store.verify_checksums,
                e.session(**over).store.verify_checksums))
    assert twin(run, tmp_path) == [(False, True)]


def test_verify_checksums_off_decodes_a_flipped_blob(tmp_path):
    """On (the default) a flipped bit raises ``StorageCorruptionError``;
    off, the blob decodes and the wrong value reaches the answer, as in
    the JAX package; ``fsck --deep`` flags the file either way."""
    flipped = _flipped_store(tmp_path)

    def run(e):
        root = e.root("flipped")
        shutil.copytree(flipped, root)
        on = e.session(**{"storage.root": root})
        e.keep(on.store.verify_checksums)
        try:
            on.sql("select k, v from t order by k").decoded_columns()
            e.keep("decoded")
        except e.mod("lifecycle").StorageCorruptionError as err:
            e.keep(type(err).__name__)
        off = e.session(**{"storage.root": root,
                           "storage.verify_checksums": False})
        e.keep(off.store.verify_checksums)
        e.keep(off.sql("select k, v from t order by k"))
        rep = e.mod("storage.fsck").fsck(root, deep=True)
        e.keep((rep["clean"], any("checksum" in p
                                  for p in rep["problems"])))
    got = twin(run, tmp_path)
    assert got[:3] == [True, "StorageCorruptionError", False]
    v = got[3].decoded_columns()["v"].tolist()
    assert v[:7] == [k * 7 for k in range(7)] and v[7] != 49
    assert got[4] == (False, True)


# --------------------------------------------- dynamic partition elimination


@pytest.mark.parametrize("limit", [1 << 17, 2, 0])
def test_partition_selector_max_build(tmp_path, limit):
    """A join probing a PARTITION BY table on its partition key prunes
    probe partitions by the build's values when the build holds at most
    ``limit`` rows: at the default 8 of 10 partitions go, at 2 (a
    three-row build) and at 0 none; the answer is the same."""
    from torch_parity import plan_scans

    q = ("select count(*) as c, sum(v) as s from fact, dim "
         "where fact.d = dim.d and dim.tag = 1")

    def run(e):
        over = {"storage.root": e.root(),
                "storage.rows_per_partition": 1 << 16}
        s = e.session(**over)
        s.sql("create table fact (k bigint, d bigint, v bigint) "
              "partition by range (d) (start 0 end 100 every 10)")
        rng = np.random.default_rng(11)
        s.sql("insert into fact values " + ", ".join(
            f"({int(rng.integers(0, 50))}, {int(rng.integers(0, 100))}, "
            f"{i})" for i in range(3000)))
        s.sql("create table dim (d bigint, tag bigint)")
        s.sql("insert into dim values (3, 1), (17, 1), (42, 2)")
        s = e.session(**over,
                      **{"storage.partition_selector_max_build": limit})
        e.keep([sc._prune_report.get("skipped_dynamic", 0)
                for sc in plan_scans(s, q)
                if hasattr(sc, "_store_parts")
                and sc._prune_report.get("candidates") == 10])
        e.keep(s.sql(q))
    got = twin(run, tmp_path)
    assert got[0] == [8 if limit > 2 else 0]


# -------------------------------------------------------------- buffer pool


def test_bufferpool_disabled_admits_nothing(tmp_path):
    """With ``bufferpool.enabled`` False there is no pool, repeated store
    scans answer as with it, and nothing is admitted; on, the second scan
    admits its partitions."""
    q = "select g, count(*) as c, sum(v) as s from t group by g order by g"

    def run(e):
        BP = e.mod("exec.bufferpool")
        w = e.session(**{"storage.root": e.root(),
                         "storage.rows_per_partition": 500})
        w.sql("create table t (g bigint, v bigint)")
        w.catalog.table("t").set_data(
            {"g": np.arange(4000, dtype=np.int64) % 7,
             "v": np.arange(4000, dtype=np.int64)}, {})
        for enabled in (False, True):
            # a private scope each, so that the second pool starts empty
            s = e.session(**{"storage.root": e.root(),
                             "bufferpool.enabled": enabled,
                             "bufferpool.admit_min_scans": 1,
                             "sched.shared_cache": False})
            for _ in range(2):
                e.keep(s.sql(q))
            pool = BP.pool_for(s)
            e.keep(None if pool is None else
                   pool.snapshot()["admits"] > 0)
    got = twin(run, tmp_path)
    assert got[2] is None and got[5] is True


# ------------------------------------------------------------- shared cache


@pytest.mark.parametrize("shared", [True, False])
def test_shared_cache_switch(tmp_path, shared):
    """Two sessions over one store root share one cache scope only while
    ``sched.shared_cache`` is on; a session without a store is always
    private."""
    def run(e):
        SC = e.mod("sched.sharedcache")
        over = {"storage.root": e.root(), "sched.shared_cache": shared}
        a, b = e.session(**over), e.session(**over)
        e.keep((SC.scope_for(a) is SC.scope_for(b),
                SC.scope_for(a).kind))
        e.keep(SC.scope_for(e.session()).kind)
    got = twin(run, tmp_path)
    assert got[0] == (shared, "store" if shared else "session")
    assert got[1] == "session"


# ------------------------------------------------------------- max variants


@pytest.mark.parametrize("variants", [4, 1])
def test_max_variants_bounds_the_generic_plans_per_skeleton(variants):
    """A point lookup whose match count changes is a new variant of its
    skeleton: at the default both variants stay and a third literal
    rebinds; at 1 each change of shape evicts the other and builds
    again."""
    q = "select k, v from pts where k = {}"

    def run(e):
        s = e.session(**{"sched.generic_plans": True,
                         "sched.max_variants": variants})
        s.sql("create table pts (k bigint, v bigint) distributed by (k)")
        k = np.concatenate([np.arange(100_000, dtype=np.int64),
                            np.array([55], dtype=np.int64)])
        s.catalog.table("pts").set_data({"k": k, "v": (k * 7) % 1000}, {})
        builds = s.stmt_log.counter("generic_builds")
        for lit in (7, 55, 8):
            e.keep(s.sql(q.format(lit)))
        e.keep(s.stmt_log.counter("generic_builds") - builds)
        e.keep([len(b) for b in s._generic_cache.values()])
    got = twin(run)
    assert got[3:] == ([2, [2]] if variants == 4 else [3, [1]])
