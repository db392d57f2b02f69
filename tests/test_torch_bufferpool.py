"""The port's device buffer pool (exec/bufferpool.py), on the CPU.

The pool holds decoded micro-partition chunks as tensors on the session's
device. Under test: pool on and off give bit-identical results (and equal
the JAX package's); a partition is admitted only after
``bufferpool.admit_min_scans`` observed scans, and then served with no
host decode; eviction is LRU by device bytes and refuses rather than
evicting a hotter entry; a store-version bump or a config swap orphans
every entry; the pool's chunks and the session's store-scan cache stay
within ``bufferpool.max_bytes`` together; and the device is part of every
key, so a session on another device is never handed this one's tensors.
"""

import numpy as np
import pytest
import torch

from cloudberry_tpu_torch import Session as TorchSession
from cloudberry_tpu_torch.exec import bufferpool as BUF
from cloudberry_tpu_torch.exec import executor as X
from cloudberry_tpu_torch.sched import sharedcache
from cloudberry_tpu_torch.utils import faultinject as FI
from torch_parity import assert_same, store_pair

QUERIES = (
    "select g, sum(v) as sv, count(*) as c from fact group by g order by g",
    "select k, v from fact where v < 90 order by v, k limit 25",
    "select g, avg(f) as af, min(v) as mn from fact where k < 500 "
    "group by g order by g",
)


@pytest.fixture(autouse=True)
def _clean():
    FI.reset_fault()
    yield
    FI.reset_fault()


def _ent(n=512, seed=0):
    return {"cols": {"v": torch.arange(seed, seed + n, dtype=torch.int64)},
            "validity": {}}


_NB = 512 * 8  # _ent() device bytes


def _key(name):
    return ("part", "t", 1, name, ("v",), 0, 1, "cpu")


# ------------------------------------------------------------ unit: policy


def test_admission_needs_min_scans():
    p = BUF.BufferPool(max_bytes=1 << 20, admit_min_scans=2)
    k = _key("p0")
    assert p.lookup(k) is None           # freq 1
    assert not p.offer(k, _ent())
    assert p.lookup(k) is None           # freq 2
    assert p.offer(k, _ent())
    assert p.lookup(k) is not None       # resident now
    snap = p.snapshot()
    assert snap["entries"] == 1 and snap["bytes"] == _NB
    assert not p.offer(k, _ent())        # re-offer: no double charge
    assert p.snapshot()["bytes"] == _NB


def test_numpy_offers_upload_once():
    p = BUF.BufferPool(max_bytes=1 << 20, admit_min_scans=1)
    k = _key("np")
    p.lookup(k)
    ro = np.frombuffer(np.arange(16, dtype=np.int64).tobytes(),
                       dtype=np.int64)
    assert not ro.flags.writeable
    assert p.offer(k, {"cols": {"v": ro}, "validity": {}},
                   device=torch.device("cpu"))
    got = p.lookup(k)["cols"]["v"]
    assert torch.is_tensor(got) and got.tolist() == list(range(16))
    assert p.snapshot()["bytes"] == 16 * 8


def test_lru_eviction_under_byte_budget():
    p = BUF.BufferPool(max_bytes=3 * _NB, admit_min_scans=2)
    keys = [_key(f"p{i}") for i in range(4)]
    for k in keys[:3]:
        p.lookup(k), p.lookup(k)
        assert p.offer(k, _ent())
    p.lookup(keys[0])  # touch: k0 is now most-recent, k1 is the head
    p.lookup(keys[3]), p.lookup(keys[3])
    assert p.offer(keys[3], _ent())
    snap = p.snapshot()
    assert snap["entries"] == 3 and snap["evictions"] == 1
    with p._lock:
        resident = set(p._entries)
    assert keys[1] not in resident
    assert keys[0] in resident and keys[3] in resident


def test_refusal_over_evicting_hotter():
    p = BUF.BufferPool(max_bytes=_NB, admit_min_scans=2)
    hot = _key("hot")
    for _ in range(5):
        p.lookup(hot)
    assert p.offer(hot, _ent())
    cold = _key("cold")
    p.lookup(cold), p.lookup(cold)
    assert not p.offer(cold, _ent())
    snap = p.snapshot()
    assert snap["refusals"] == 1 and snap["evictions"] == 0
    assert p.lookup(hot) is not None


def test_oversize_refused_sweep_clear_and_grow_only():
    p = BUF.BufferPool(max_bytes=2 * _NB, admit_min_scans=1)
    for i in range(2):
        k = _key(f"p{i}")
        p.lookup(k)
        assert p.offer(k, _ent())
    big = _key("big")
    p.lookup(big)
    assert not p.offer(big, _ent(n=4096))
    assert p.snapshot()["entries"] == 2
    assert p.sweep(lambda k: k[3] == "p1") == 1
    assert p.snapshot()["bytes"] == _NB
    assert p.clear() == 1 and p.snapshot()["tracked_keys"] == 0
    p.grow(4 * _NB)
    p.grow(_NB)  # never shrinks under a peer session
    assert p.snapshot()["max_bytes"] == 4 * _NB


def test_fault_seams_suppress_admit_and_force_refusal():
    p = BUF.BufferPool(max_bytes=_NB, admit_min_scans=1)
    k = _key("p0")
    p.lookup(k)
    FI.inject_fault("bufpool_admit", "skip")
    assert not p.offer(k, _ent())
    FI.reset_fault()
    assert p.offer(k, _ent())
    k2 = _key("p1")
    p.lookup(k2)
    FI.inject_fault("bufpool_evict", "skip")
    assert not p.offer(k2, _ent())
    assert p.lookup(k) is not None


# -------------------------------------------------------- through sessions


def _mk_store(tmp_path, n=6000, rpp=1000, **ov):
    p = store_pair(tmp_path, rpp, **ov)
    p.sql("create table fact (k bigint, g bigint, v bigint, f double)")
    rng = np.random.default_rng(5)
    g = rng.integers(0, 9, n)
    v = rng.integers(0, 100, n)
    f = rng.random(n)
    rows = ",".join(f"({i}, {int(g[i])}, {int(v[i])}, {float(f[i])!r})"
                    for i in range(n))
    p.sql(f"insert into fact values {rows}")
    return p


def _open(cfg, **ov):
    return TorchSession(cfg.with_overrides(**ov) if ov else cfg,
                        device="cpu")


def _exact(a, b):
    """Bit-identical batches: same names, dtypes, values, NULLs."""
    assert [f.name for f in a.schema.fields] == \
        [f.name for f in b.schema.fields]
    for f in a.schema.fields:
        x, y = np.asarray(a.columns[f.name]), np.asarray(b.columns[f.name])
        assert x.dtype == y.dtype
        assert x.tobytes() == y.tobytes(), f.name


def test_pool_on_off_bit_identical_and_equal_to_jax(tmp_path):
    p = _mk_store(tmp_path).reopen()
    on = p.ts
    off = _open(p.tcfg, **{"bufferpool.max_bytes": 0})
    sharedcache.scope_for(on).clear()
    for q in QUERIES:
        want = p.js.sql(q)
        for _ in range(3):      # cold, admitted, pool-served
            got = _open(p.tcfg).sql(q)
            _exact(got, off.sql(q))
            assert_same(got, want)
    assert BUF.pool_for(on).snapshot()["hits"] > 0
    assert BUF.pool_for(off) is None


def test_admission_then_zero_host_decodes(tmp_path):
    p = _mk_store(tmp_path)
    cfg = p.tcfg
    q = QUERIES[0]
    sharedcache.drop_store_scope(cfg.storage.root)
    runs = []
    for _ in range(3):          # each a fresh session of the same scope
        s = _open(cfg)
        s.sql(q)
        runs.append(s.counters.snapshot())
    parts = 6
    assert runs[0]["partitions_decoded"] == parts
    assert runs[0].get("bufpool_admits", 0) == 0      # seen once
    assert runs[1]["partitions_decoded"] == parts
    assert runs[1]["bufpool_admits"] == parts         # seen twice
    assert runs[2].get("partitions_decoded", 0) == 0  # served from the pool
    assert runs[2]["bufpool_hits"] == parts
    pool = BUF.pool_for(s)
    assert pool.snapshot()["bytes"] == pool.table_bytes("fact") > 0
    # within one session, the store-scan cache serves the repeat
    s.sql(q)
    assert s.counters.counter("store_scan_cache_hits") == 1


def test_resident_bytes_are_device_bytes(tmp_path):
    p = _mk_store(tmp_path)
    cfg = p.tcfg.with_overrides(**{"bufferpool.admit_min_scans": 1})
    sharedcache.drop_store_scope(cfg.storage.root)
    s = _open(cfg)
    s.sql("select sum(v) as s from fact")
    pool = BUF.pool_for(s)
    with pool._lock:
        ents = list(pool._entries.values())
    assert len(ents) == 6
    for value, nb, _ in ents:
        v = value["cols"]["v"]
        assert torch.is_tensor(v) and v.device == s.device
        assert nb == v.numel() * v.element_size()


def _resident(s) -> int:
    """Device bytes of store reads the session keeps: the pool's chunks
    plus its store-scan cache entries."""
    return BUF.pool_for(s).snapshot()["bytes"] + sum(
        X._nbytes(v) for v in s._store_scan_cache.values())


@pytest.mark.parametrize("budget,cached", [(100_000, True),
                                           (60_000, False)],
                         ids=["room for the scan cache",
                              "the pool fills the budget"])
def test_scan_cache_and_pool_stay_within_max_bytes(tmp_path, budget,
                                                   cached):
    """One column of fact is 6 chunks of 8,000 bytes: the pool holds
    48,000, and a six-part scan's ``torch.cat`` copy 48,000 more. The
    scan cache keeps it only where both fit in ``bufferpool.max_bytes``;
    a second column's admissions then evict it, never over the budget."""
    p = _mk_store(tmp_path)
    cfg = p.tcfg.with_overrides(**{"bufferpool.admit_min_scans": 1,
                                   "bufferpool.max_bytes": budget})
    sharedcache.drop_store_scope(cfg.storage.root)
    s = _open(cfg)
    q = "select sum(v) as s from fact"
    want = s.sql(q).decoded_columns()["s"].tolist()
    assert BUF.pool_for(s).snapshot()["bytes"] == 48_000
    assert bool(s._store_scan_cache) == cached
    assert s.counters.counter("store_scan_cache_refusals") == int(not cached)
    assert _resident(s) <= budget
    assert s.sql(q).decoded_columns()["s"].tolist() == want
    assert s.counters.counter("store_scan_cache_hits") == int(cached)
    assert s.counters.counter("partitions_decoded") == 6
    s.sql("select sum(g) as s from fact")
    assert _resident(s) <= budget


def test_version_bump_invalidates_by_key(tmp_path):
    p = _mk_store(tmp_path)
    cfg = p.tcfg.with_overrides(**{"bufferpool.admit_min_scans": 1})
    sharedcache.drop_store_scope(cfg.storage.root)
    q = "select sum(v) as s, count(*) as c from fact"
    a = _open(cfg)
    before = a.sql(q).decoded_columns()["s"].tolist()
    w = _open(cfg)
    w.sql("update fact set v = v + 1 where k < 10")
    b = _open(cfg)
    got = b.sql(q).decoded_columns()
    assert b.counters.counter("bufpool_hits") == 0   # old-version keys
    assert got["s"].tolist() == [before[0] + 10]


def test_config_swap_never_serves_foreign_entries(tmp_path):
    p = _mk_store(tmp_path)
    cfg = p.tcfg.with_overrides(**{"bufferpool.admit_min_scans": 1})
    sharedcache.drop_store_scope(cfg.storage.root)
    _open(cfg).sql(QUERIES[0])
    same = _open(cfg)
    same.sql(QUERIES[0])
    assert same.counters.counter("bufpool_hits") == 6
    other = _open(cfg.with_overrides(**{"planner.autostats": "none"}))
    other.sql(QUERIES[0])
    assert other.counters.counter("bufpool_hits") == 0


def test_the_device_is_part_of_every_key(tmp_path, monkeypatch):
    """Two CPU sessions over one store root share a scope; one of them
    claims another device. It must never be served the first one's pool
    entries, join indexes or store-scan entries — each holds tensors on
    the device that built it."""
    p = _mk_store(tmp_path)
    p.sql("create table dim (g bigint, name text)")
    p.sql("insert into dim values " +
          ",".join(f"({i}, 'n{i}')" for i in range(9)))
    cfg = p.tcfg.with_overrides(**{"bufferpool.admit_min_scans": 1})
    sharedcache.drop_store_scope(cfg.storage.root)
    a, b = _open(cfg), _open(cfg)
    assert a._cache_scope is b._cache_scope
    real = sharedcache.device_token
    monkeypatch.setattr(sharedcache, "device_token",
                        lambda s: "cuda:7" if s is b else real(s))
    q = "select g, sum(v) as s from fact group by g order by g"
    a.sql(q)
    a.sql(q)
    assert a.counters.counter("store_scan_cache_hits") == 1
    b.sql(q)
    assert b.counters.counter("bufpool_hits") == 0
    assert b.counters.counter("partitions_decoded") == 6
    keys = list(BUF.pool_for(a)._entries)
    assert {k[-1] for k in keys} == {"cpu", "cuda:7"}
    # join indexes: a warm (RAM) dimension keys its index by device too
    for s in (a, b):
        s.catalog.table("fact").ensure_loaded()
    from cloudberry_tpu_torch.exec import joinindex as JI

    spec = JI.JoinIndexSpec("$jix:fact:k:64:table", "fact", ("k",), 64,
                            6000)
    assert JI.index_key(a, spec) != JI.index_key(b, spec)
