#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (cloudberry_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # TPC-H SF1 seed 1, TPC-DS scale 100

Phases (any failure exits non-zero, and nothing is caught and passed over):

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: nvcc compiles the kernels of cloudberry_tpu_torch/csrc (one
   process per source, in parallel) into cloudberry_tpu_torch/build/;
3. TPC-H: Q1, Q3 and Q5 through ``Session()`` on CUDA. Each query runs
   once to warm up (and to record the inputs each kernel gets), then once
   more with the kernel launch counts set to 0 just before and read just
   after; the counts must show dense_agg on Q1 and Q5, sorted_seg on Q3 and
   probe_join on Q5. Each result must equal, exactly, a numpy oracle written
   here and the same query run by a ``Session(device="cpu")`` of the port
   (the kernels' plain versions). Four more runs of each query give the
   spread of its wall time;
4. TPC-DS: the 30 queries of ``cloudberry_tpu_torch/tpcds.py`` over
   tpcds-lite at scale 100, seed 0 (3,000,000 store_sales rows). A warm-up
   run holds every kernel call against its plain version on the same
   inputs; then a run with the launch counts zeroed before and read after,
   whose result must equal the CPU run of the port (NULLs included; ints,
   DECIMALs, dates and strings exactly, floats within rtol 1e-9 plus 1e-12
   times the column's sum of magnitudes) and reach the same kernels. The
   window queries (q12, q20, q36, q86, q98) get five timed runs each;
5. windows at scale: ``tpcds.WINDOW_QUERY`` (every window function family
   and frame kind) over all 3M store_sales rows, then over an empty
   selection and over one row, each equal to the CPU run; its wall time
   and the peak device memory;
6. growth: a skew join of 1,200,000 probe rows (25 % on one key, which the
   build holds 12 times) whose true pair count exceeds the planner's
   estimate: the join's buffer must grow (``growth_events``), and the
   count and sum must equal numpy's;
7. storage: the host packages that import (zstandard, cryptography,
   pandas) and the native codec, which must have built with g++ and
   loaded. All eight TPC-H tables written through a store-backed
   ``Session`` into a fresh ``storage.root`` in a temporary directory
   (removed at the end), lineitem once more with PARTITION BY RANGE
   (l_shipdate), one 365-day range a year from 1992-01-01 in days since
   1970, and customer's key, nation, balance and segment columns in a
   seeded random row order in 512-row micro-partitions; each table's
   manifest size and read time. Q1, Q3 and Q5 then run from fresh
   sessions, every table cold, in four tiers each: a cleared cache scope
   (host read, decode, upload), a second session (the buffer pool
   admits), a third (pool-served), and that session again (the
   store-scan cache where an entry fits beside the pool in
   ``bufferpool.max_bytes``, else the pool). Every tier must equal the
   numpy oracle and phase 3 exactly, launch the kernels phase 3 launched
   and keep the pool and the scan cache within ``bufferpool.max_bytes``;
   one more run holds every kernel call against its plain version. Per
   tier: wall ms, partitions read and decoded, read-and-decode MB/s,
   manifest and footer reads and their host ms, pool hits, misses,
   admits, evictions, refusals and resident bytes, scan-cache hits,
   refusals and bytes. Pruning: Q1 and Q3 on the partitioned lineitem
   (prune reports and kernel input sizes; equal to the unpartitioned
   run) and a c_custkey point lookup that the footer blooms prune. Join
   index: Q3 and Q5 twice in a RAM session; the second run must use the
   cached index, which must equal ``kernels.build_sort`` on the device,
   whose time is printed. DML last, each against numpy: COPY FROM of the
   SF1 orders as a '|'-delimited file, COPY TO (the same bytes) and back,
   COPY with SEGMENT REJECT LIMIT and LOG ERRORS over four bad lines,
   CREATE TABLE AS of Q3's join, INSERT ... SELECT, UPDATE orders and
   DELETE FROM lineitem; a fresh session must see every change;
8. kernels: each kernel, on the inputs the TPC-H path gave it and on
   synthetic inputs at the main path's shapes plus edge cases (empty
   selection, ragged N, int64 wraparound, duplicate build keys, one hot
   cell, cell domains for each of dense_agg's modes, a skewed group, odd
   capacities; for probe_join multi-column, out-of-range, negative, bool,
   int32 and float keys, mixed payload dtypes, an empty build selection,
   key spans whose product is 2^32), must equal its plain version on the
   card; then its median time over 20 cold-cache runs on the device alone
   (``Timer.device``) and with the wrapper's host work (``wrapper_ms``),
   beside its plain version's, one PyTorch library call computing the same
   function, and its bound (bytes over 3.35 TB/s or operations over 67
   T/s, whichever is larger). The probe-join operator is also timed as it
   was before its fused kernel (key packing in PyTorch around the kernel)
   and as the executor's sorted lookup, and each Q5 probe join is traced
   with torch.profiler: it must be one device kernel;
9. report: the card line, one JSON line of kernels (launches summed over
   the counted runs of phases 3 to 7), and last the JSON line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12      # H100 SXM non-tensor float32 peak
REPLACES = {
    "dense_agg": "cloudberry_tpu/exec/pallas_kernels.py:84",
    "probe_join": "cloudberry_tpu/exec/pallas_kernels.py:150",
    "sorted_seg": "cloudberry_tpu/exec/pallas_kernels.py:332",
}
SEED = 1          # TPC-H data and the synthetic kernel inputs
REPS = 20         # timed launches per kernel
QUERY_RUNS = 5    # timed runs per query, tables already on the card
EXPECTED = {"q1": {"dense_agg"}, "q3": {"sorted_seg"},
            "q5": {"dense_agg", "probe_join"}}
DS_SCALE = 100    # tpcds-lite: 3,000,000 store_sales rows
DS_SEED = 0
WINDOWED = ("q12", "q20", "q36", "q86", "q98")
FLOAT_RTOL = 1e-9
ATOL_PER_MAGNITUDE = 1e-12
SKEW_ROWS = 1_200_000


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ------------------------------------------------------------ numpy oracle

def _cents(x):
    return np.rint(np.asarray(x, dtype=np.float64) * 100).astype(np.int64)


def _lookup(keys, probe):
    """Row index of each probe key in a unique key column."""
    order = np.argsort(keys, kind="stable")
    pos = np.searchsorted(keys[order], probe)
    pos = np.clip(pos, 0, len(keys) - 1)
    check(np.array_equal(keys[order][pos], probe), "oracle: dangling key")
    return order[pos]


def oracle(raw, q, D):
    """Independent numpy answers, physical form: strings as str, DECIMAL
    as int64 fixed-point, DATE as day numbers, avg as float64."""
    li = raw["lineitem"]
    ep, disc = _cents(li["l_extendedprice"]), _cents(li["l_discount"])
    if q == "q1":
        m = li["l_shipdate"] <= D("1998-12-01") - 90
        rf, ls = li["l_returnflag"][m], li["l_linestatus"][m]
        qty, tax = _cents(li["l_quantity"])[m], _cents(li["l_tax"])[m]
        e, d = ep[m], disc[m]
        out = {k: [] for k in ("l_returnflag", "l_linestatus", "sum_qty",
                               "sum_base_price", "sum_disc_price",
                               "sum_charge", "avg_qty", "avg_price",
                               "avg_disc", "count_order")}
        for a, b in sorted(set(zip(rf.tolist(), ls.tolist()))):
            g = (rf == a) & (ls == b)
            c = np.int64(g.sum())
            out["l_returnflag"].append(a)
            out["l_linestatus"].append(b)
            out["sum_qty"].append(qty[g].sum())
            out["sum_base_price"].append(e[g].sum())
            out["sum_disc_price"].append((e[g] * (100 - d[g])).sum())
            out["sum_charge"].append(
                (e[g] * (100 - d[g]) * (100 + tax[g])).sum())
            for name, v in (("avg_qty", qty), ("avg_price", e),
                            ("avg_disc", d)):
                out[name].append(np.float64(v[g].sum()) / np.float64(c)
                                 / 100.0)
            out["count_order"].append(c)
        return out
    if q == "q3":
        cu, od = raw["customer"], raw["orders"]
        cust_ok = cu["c_mktsegment"] == "BUILDING"
        o_ok = (od["o_orderdate"] < D("1995-03-15")) \
            & cust_ok[_lookup(cu["c_custkey"], od["o_custkey"])]
        orow = _lookup(od["o_orderkey"], li["l_orderkey"])
        m = (li["l_shipdate"] > D("1995-03-15")) & o_ok[orow]
        keys, inv = np.unique(li["l_orderkey"][m], return_inverse=True)
        rev = np.zeros(len(keys), dtype=np.int64)
        np.add.at(rev, inv, (ep * (100 - disc))[m])
        first = _lookup(od["o_orderkey"], keys)
        odate = od["o_orderdate"][first].astype(np.int32)
        prio = od["o_shippriority"][first].astype(np.int32)
        top = np.lexsort((keys, odate, -rev))[:10]
        return {"l_orderkey": keys[top], "revenue": rev[top],
                "o_orderdate": odate[top], "o_shippriority": prio[top]}
    if q == "q5":
        cu, od, su = raw["customer"], raw["orders"], raw["supplier"]
        na, rg = raw["nation"], raw["region"]
        asia = rg["r_regionkey"][rg["r_name"] == "ASIA"]
        orow = _lookup(od["o_orderkey"], li["l_orderkey"])
        odate = od["o_orderdate"][orow]
        crow = _lookup(cu["c_custkey"], od["o_custkey"][orow])
        srow = _lookup(su["s_suppkey"], li["l_suppkey"])
        c_nat, s_nat = cu["c_nationkey"][crow], su["s_nationkey"][srow]
        nrow = _lookup(na["n_nationkey"], s_nat)
        m = (odate >= D("1994-01-01")) & (odate < D("1995-01-01")) \
            & (c_nat == s_nat) & np.isin(na["n_regionkey"][nrow], asia)
        names = na["n_name"][nrow][m]
        rev = (ep * (100 - disc))[m]
        out = {}
        for nm in sorted(set(names.tolist())):
            out[nm] = rev[names == nm].sum()
        order = sorted(out, key=lambda k: -out[k])
        return {"n_name": order,
                "revenue": [out[k] for k in order]}
    raise KeyError(q)


def physical(batch):
    """A result batch's selected rows, physical form (strings decoded)."""
    sel = np.asarray(batch.sel)
    out = {}
    for f in batch.schema.fields:
        arr = np.asarray(batch.columns[f.name])[sel]
        d = batch.dicts.get(f.name)
        out[f.name] = d.decode(arr) if d is not None else arr
    return out


def same(got: dict, want: dict, what: str):
    check(list(got) == list(want), f"{what}: columns {list(got)} vs "
          f"{list(want)}")
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype == object or g.dtype == object:
            ok = g.shape == w.shape and all(
                a == b for a, b in zip(g.tolist(), w.tolist()))
        elif w.dtype.kind == "f" or g.dtype.kind == "f":
            ok = g.shape == w.shape and np.array_equal(
                g.astype(np.float64).view(np.int64),
                w.astype(np.float64).view(np.int64))
        else:
            ok = g.shape == w.shape and np.array_equal(g.astype(np.int64),
                                                       w.astype(np.int64))
        check(ok, f"{what}: column {k} differs:\n got  {g[:10]}\n want "
              f"{w[:10]}")


def with_nulls(batch):
    """A result's selected rows as {column: (values, valid mask)}, values
    in physical form (DECIMAL cents, day numbers, dictionary codes
    decoded)."""
    sel = np.asarray(batch.sel)
    out = {}
    for f in batch.schema.fields:
        v = batch.validity.get(f.name)
        valid = np.ones(int(sel.sum()), dtype=bool) if v is None \
            else np.asarray(v).astype(bool)[sel]
        arr = np.asarray(batch.columns[f.name])[sel]
        d = batch.dicts.get(f.name)
        out[f.name] = (d.decode(arr) if d is not None else arr, valid)
    return out


def same_nulls(got: dict, want: dict, what: str) -> float:
    """Equal NULL masks, and equal values where valid: exactly, except
    float64 within FLOAT_RTOL * |want| + ATOL_PER_MAGNITUDE * (the column's
    sum of magnitudes; windowed float sums are differences of prefix sums,
    rounded at the prefix's magnitude). Returns the largest float
    difference seen."""
    check(list(got) == list(want), f"{what}: columns {list(got)} vs "
          f"{list(want)}")
    worst = 0.0
    for k, (w, wv) in want.items():
        g, gv = got[k]
        check(g.shape == w.shape and np.array_equal(gv, wv),
              f"{what}: column {k}: shape or NULLs differ")
        g, w = g[wv], w[wv]
        if w.dtype.kind == "f" or g.dtype.kind == "f":
            check(g.dtype == w.dtype, f"{what}: column {k} dtype")
            diff = np.abs(g - w)
            tol = FLOAT_RTOL * np.abs(w) + ATOL_PER_MAGNITUDE * max(
                1.0, float(np.abs(w).sum()))
            ok = bool(np.all(diff <= tol))
            worst = max(worst, float(diff.max()) if diff.size else 0.0)
        elif w.dtype == object or g.dtype == object:
            ok = g.tolist() == w.tolist()
        else:
            ok = g.dtype == w.dtype and np.array_equal(g, w)
        check(ok, f"{what}: column {k} differs:\n got  {g[:10]}\n want "
              f"{w[:10]}")
    return worst


def copy_tables(src, dst, names):
    """Install src's encoded tables in dst unchanged (catalog/carry.py)."""
    from cloudberry_tpu_torch.catalog import carry

    for n in names:
        t = src.catalog.table(n)
        carry.load_encoded(dst, n, t.schema.fields, t.data, t.validity,
                           {c: d.values for c, d in t.dicts.items()},
                           t.policy)


def skew_join_tables(n):
    """The skew join's inputs: n probe rows, 25 % of them on key 0, which
    the build side holds 12 times; every other build key once."""
    rng = np.random.default_rng(13)
    probe_k = np.where(rng.random(n) < 0.25, 0,
                       rng.integers(1, 120_000, n)).astype(np.int64)
    probe_v = rng.integers(0, 1000, n).astype(np.int64)
    build_k = np.concatenate([np.zeros(12, dtype=np.int64),
                              np.arange(1, 120_000, dtype=np.int64)])
    build_v = np.arange(len(build_k), dtype=np.int64)
    return probe_k, probe_v, build_k, build_v


def skew_join_oracle(probe_k, probe_v, build_k, build_v):
    """count(*) and sum(v + w) of the inner join on k, in numpy."""
    order = np.argsort(build_k, kind="stable")
    lo = np.searchsorted(build_k[order], probe_k, side="left")
    hi = np.searchsorted(build_k[order], probe_k, side="right")
    pairs = hi - lo
    cw = np.concatenate([[0], np.cumsum(build_v[order])])
    return int(pairs.sum()), int((probe_v * pairs).sum()
                                 + (cw[hi] - cw[lo]).sum())


# ------------------------------------------------------------------ timing

class Timer:
    """Median ms of a function over ``reps`` runs, each after an L2 flush
    (the main path finds its inputs cold), taken two ways:

    - ``device``: a spin kernel (``torch.cuda._sleep``) is queued after the
      flush and before the start event, and outlasts the host's enqueue of
      ``fn``, so the events bracket only ``fn``'s device work. Every run
      checks this against the host clock; a function that blocks the host
      (a device-to-host read) fails the check and has no device time.
    - ``wrapper``: the start event follows the flush directly, so the time
      includes the host's work in the wrapper before the launch (argument
      checks, allocations, the ctypes call).
    """

    def __init__(self, torch, flush, reps):
        self.torch, self.flush, self.reps = torch, flush, reps
        cycles = 10_000_000
        torch.cuda._sleep(cycles)              # warm the spin kernel
        a, b = self._events()
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        self.cycles_per_ms = cycles / a.elapsed_time(b)

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def wrapper(self, fn):
        fn()
        self.torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a, b = self._events()
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def device(self, fn):
        """Device ms, or None when the host's enqueue of ``fn`` outlasted
        the spin kernel even with a 64x longer lead (then the gap between
        the events would count host time)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        lead_ms = max(0.5, 4 * enqueue_ms)
        for _ in range(4):
            times = self._device_runs(fn, lead_ms)
            if times is not None:
                return float(np.median(times))
            lead_ms *= 4
        return None

    def _device_runs(self, fn, lead_ms):
        torch = self.torch
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            a, b = self._events()
            h0 = time.perf_counter()
            torch.cuda._sleep(int(lead_ms * self.cycles_per_ms))
            a.record()
            fn()
            b.record()
            host_ms = (time.perf_counter() - h0) * 1e3
            b.synchronize()
            if host_ms >= 0.5 * lead_ms:   # margin for clock drift
                return None
            times.append(a.elapsed_time(b))
        return times


def max_abs_err(torch, got, want):
    err = 0.0
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g), torch.as_tensor(w)
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"shape/dtype {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if g.numel() == 0:
            continue
        if g.dtype.is_floating_point:
            err = max(err, float((g - w).abs().max()))
        else:  # exact types: the number of differing elements
            err = max(err, float((g != w).sum()))
    return err


def profile_queries(torch, session, queries):
    """Trace each query of {label: sql} once (tables already on the card):
    device time by operator, and the device's busy share of the wall
    time."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs("chiprun_out", exist_ok=True)
    for q, sql in queries.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            session.sql(sql)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=25)
        kernels = [e for e in prof.events()
                   if e.device_type.name == "CUDA"]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in kernels)
        busy, end = 0.0, float("-inf")
        for a, b in spans:      # union of kernel intervals
            if b > end:
                busy += b - max(a, end)
                end = b
        with open(f"chiprun_out/profile_{q}.txt", "w") as f:
            f.write(table)
        log(f"[profile] {q}: wall {wall_us / 1e3:.3f} ms, device busy "
            f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall), "
            f"{len(kernels)} device kernels")
        log(table)


# ---------------------------------------------------------- storage phase

STORE_QUERIES = ("q1", "q3", "q5")
STORE_TIERS = ("cold", "pool admits", "pool-served", "scan cache")
PART_START, PART_END, PART_EVERY = "1992-01-01", "1999-01-01", 365
BLOOM_RPP = 512       # rows per micro-partition of the point-lookup table
SREH_ROWS = 100_000   # orders lines of the reject-limit load
_DDL_TYPE = {"bool": "boolean", "int32": "integer", "int64": "bigint",
             "float64": "double", "date": "date", "string": "text"}


def ddl_columns(schema) -> str:
    """A schema as the column list of CREATE TABLE."""
    out = []
    for f in schema.fields:
        base = f.type.base.value
        out.append(f"{f.name} " + (f"decimal(15,{f.type.scale})"
                                   if base == "decimal" else _DDL_TYPE[base]))
    return ", ".join(out)


def tbl_lines(cols: dict, schema) -> list[str]:
    """A generator table's rows as '|'-delimited lines, in the text form
    COPY TO writes (ISO dates, DECIMALs from their integer units)."""
    out = []
    for f in schema.fields:
        v = np.asarray(cols[f.name])
        base = f.type.base.value
        if base == "decimal":
            s = f.type.scale
            units = np.rint(v.astype(np.float64) * 10 ** s).astype(np.int64)
            out.append([f"{'-' if x < 0 else ''}{abs(x) // 10 ** s}."
                        f"{abs(x) % 10 ** s:0{s}d}" for x in units.tolist()])
        elif base == "date":
            out.append((np.datetime64("1970-01-01")
                        + v.astype("timedelta64[D]")).astype(str).tolist())
        else:
            out.append([str(x) for x in v.tolist()])
    return ["|".join(r) for r in zip(*out)]


def physical_of(cols: dict, fields, rows=None) -> dict:
    """Some columns (``fields``) of a generator table, optionally some rows,
    in the physical form ``physical`` gives a result: DECIMALs as integer
    units."""
    out = {}
    for f in fields:
        v = np.asarray(cols[f.name])
        v = v if rows is None else v[rows]
        if f.type.base.value == "decimal":
            v = np.rint(v.astype(np.float64) * 10 ** f.type.scale
                        ).astype(np.int64)
        out[f.name] = v
    return out


def store_scan_reports(session, sql) -> list[dict]:
    """The prune report, partitions kept and capacity of every store scan
    of a statement's optimized plan."""
    from cloudberry_tpu_torch.exec.executor import scans_of
    from cloudberry_tpu_torch.plan.binder import Binder
    from cloudberry_tpu_torch.plan.planner import _optimize
    from cloudberry_tpu_torch.sql.parser import parse_sql

    plan = _optimize(Binder(session.catalog).bind_query(parse_sql(sql)),
                     session)
    return [{"table": s.table_name, **s._prune_report,
             "parts": len(s._store_parts), "capacity": s.capacity}
            for s in scans_of(plan) if hasattr(s, "_store_parts")]


def q3_groups(raw, D):
    """Every (l_orderkey, revenue, o_orderdate, o_shippriority) group of
    TPC-H Q3's join and filters, by key (the oracle's q3 without the
    top 10)."""
    li, cu, od = raw["lineitem"], raw["customer"], raw["orders"]
    ep, disc = _cents(li["l_extendedprice"]), _cents(li["l_discount"])
    cust_ok = cu["c_mktsegment"] == "BUILDING"
    o_ok = (od["o_orderdate"] < D("1995-03-15")) \
        & cust_ok[_lookup(cu["c_custkey"], od["o_custkey"])]
    m = (li["l_shipdate"] > D("1995-03-15")) \
        & o_ok[_lookup(od["o_orderkey"], li["l_orderkey"])]
    keys, inv = np.unique(li["l_orderkey"][m], return_inverse=True)
    rev = np.zeros(len(keys), dtype=np.int64)
    np.add.at(rev, inv, (ep * (100 - disc))[m])
    first = _lookup(od["o_orderkey"], keys)
    return {"l_orderkey": keys, "revenue": rev,
            "o_orderdate": od["o_orderdate"][first],
            "o_shippriority": od["o_shippriority"][first]}


def storage_phase(kit, raw, ram, ram_session, names) -> dict:
    """Phase 7 (module docstring). ``ram``: {query: (physical result,
    kernels launched)} of phase 3; ``ram_session``: phase 3's session,
    whose tables the join-index runs copy. Returns the phase's report."""
    import shutil
    import tempfile

    from cloudberry_tpu_torch import native
    from cloudberry_tpu_torch.storage import micropartition as MP
    from cloudberry_tpu_torch.storage.table_store import TableStore

    def importable(name):
        try:
            __import__(name)
            return True
        except ImportError:
            return False

    host = {n: importable(n) for n in ("zstandard", "cryptography",
                                       "pandas")}
    lib = native.load_native()
    host["codec"] = "zstd" if MP._zstd is not None else "zlib"
    host["native_codec_loaded"] = lib is not None
    log(f"[store] host packages importable: zstandard {host['zstandard']}, "
        f"cryptography {host['cryptography']}, pandas {host['pandas']}; "
        f"micro-partitions compress with {host['codec']}; native codec "
        f"({os.path.relpath(native.SOURCE)}, g++ into "
        f"{os.path.relpath(native.BUILD_DIR)}/) "
        f"{'loaded' if lib is not None else 'NOT loaded'}")
    check(lib is not None, "the native codec did not build or load: the "
          "store path must run on it")

    # every partition read and decode, and every manifest and footer read
    # (JSON parses), counted and timed where they happen
    reads = {"calls": 0, "parts": 0, "bytes": 0, "s": 0.0,
             "manifests": 0, "manifest_s": 0.0, "footers": 0,
             "footer_s": 0.0}
    real_read = TableStore.read_partitions
    real_manifest = TableStore.read_manifest
    real_footer = MP.read_footer

    def counting_read(self, table, parts, *a, **kw):
        t0 = time.perf_counter()
        cols, validity = real_read(self, table, parts, *a, **kw)
        reads["s"] += time.perf_counter() - t0
        reads["calls"] += 1
        reads["parts"] += len(parts)
        reads["bytes"] += sum(v.nbytes for v in (*cols.values(),
                                                 *validity.values()))
        return cols, validity

    def timed(fn, what):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                reads[f"{what}_s"] += time.perf_counter() - t0
                reads[f"{what}s"] += 1
        return call

    TableStore.read_partitions = counting_read
    TableStore.read_manifest = timed(real_manifest, "manifest")
    MP.read_footer = timed(real_footer, "footer")
    tmp = tempfile.mkdtemp(prefix="cb_store_")
    try:
        out = _storage_runs(kit, raw, ram, ram_session, names, reads,
                            os.path.join(tmp, "tpch"))
    finally:
        TableStore.read_partitions = real_read
        TableStore.read_manifest = real_manifest
        MP.read_footer = real_footer
        shutil.rmtree(tmp, ignore_errors=True)
    out["host"] = host
    return out


def _storage_runs(kit, raw, ram, ram_session, names, reads, root) -> dict:
    import re

    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.columnar.batch import encode_column
    from cloudberry_tpu_torch.exec import bufferpool as BUF
    from cloudberry_tpu_torch.exec import cuda_kernels as CK
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.exec import joinindex as JI
    from cloudberry_tpu_torch.exec import kernels as K
    from cloudberry_tpu_torch.exec.executor import all_nodes
    from cloudberry_tpu_torch.plan.binder import Binder
    from cloudberry_tpu_torch.plan.planner import _optimize
    from cloudberry_tpu_torch.sched import sharedcache
    from cloudberry_tpu_torch.sql.parser import parse_sql
    from cloudberry_tpu_torch.types import date_to_days as D

    torch = kit.torch
    report = {}
    cfg = ct.Config().with_overrides(**{"storage.root": root})

    def held(name_of_run, fn, sizes=None):
        """Run fn with every kernel call held against its plain version."""
        for k in CK.LAUNCHES:
            setattr(CK, k, kit.holding(k, name_of_run, sizes))
        try:
            return fn()
        finally:
            for k, fn_ in kit.originals.items():
                setattr(CK, k, fn_)

    # --------------------------------------------------------- the write
    t0 = time.perf_counter()
    w = ct.Session(cfg)
    tpch.load_tables(w, tpch.SCHEMAS, tpch.DIST_KEYS, raw)
    write_s = time.perf_counter() - t0
    disk = w.store.disk_usage(fresh=True)
    li_parts = len(w.store.read_manifest("lineitem")["partitions"])
    n_li = len(raw["lineitem"]["l_orderkey"])
    check(li_parts == -(-n_li // w.store.rows_per_partition),
          f"lineitem: {li_parts} micro-partitions")
    report["write"] = {"s": write_s, "bytes_on_disk": disk,
                       "lineitem_partitions": li_parts}
    log(f"[store] wrote the eight TPC-H tables ({n_li} lineitem rows, "
        f"{li_parts} lineitem micro-partitions of at most "
        f"{w.store.rows_per_partition} rows) through a store-backed "
        f"Session in {write_s:.2f} s: {disk} bytes on disk")

    # partitioned lineitem: one RANGE partition per 365 days of l_shipdate,
    # bounds in days since 1970
    schema = tpch.SCHEMAS["lineitem"]
    lo, hi = D(PART_START), D(PART_END)
    t0 = time.perf_counter()
    w.sql(f"create table lineitem_p ({ddl_columns(schema)}) partition by "
          f"range (l_shipdate) (start {lo} end {hi} every {PART_EVERY})")
    t = w.catalog.table("lineitem_p")
    t.set_data({f.name: encode_column(raw["lineitem"][f.name], f, t.dicts)
                for f in schema.fields}, t.dicts)
    pkeys = [p["pkey"] for p in
             w.store.read_manifest("lineitem_p")["partitions"]]
    part_s = time.perf_counter() - t0
    report["write"].update(partitioned_s=part_s, partitioned_pkeys=pkeys)
    log(f"[store] lineitem_p: PARTITION BY RANGE (l_shipdate) (START {lo} "
        f"END {hi} EVERY {PART_EVERY}) — {PART_START} to {PART_END} in "
        f"days since 1970 — written in {part_s:.2f} s as {len(pkeys)} "
        f"micro-partitions {pkeys}")

    # point-lookup table: customer's key, nation, balance and segment in a
    # seeded random row order, in small micro-partitions, so min/max cannot
    # prune a c_custkey point and the footer blooms must. (Every footer
    # carries the table's whole string dictionaries, so the wide text
    # columns would make each of the 293 footer reads megabytes of JSON.)
    rng = np.random.default_rng(SEED)
    cu = raw["customer"]
    perm = rng.permutation(len(cu["c_custkey"]))
    b_fields = [f for f in tpch.SCHEMAS["customer"].fields if f.name in
                ("c_custkey", "c_nationkey", "c_acctbal", "c_mktsegment")]
    t0 = time.perf_counter()
    wb = ct.Session(cfg.with_overrides(
        **{"storage.rows_per_partition": BLOOM_RPP}))
    wb.sql("create table customer_b (" + ddl_columns(
        SimpleNamespace(fields=b_fields)) + ")")
    t = wb.catalog.table("customer_b")
    t.set_data({f.name: encode_column(cu[f.name][perm], f, t.dicts)
                for f in b_fields}, t.dicts)
    n_b = len(wb.store.read_manifest("customer_b")["partitions"])
    log(f"[store] customer_b: {n_b} micro-partitions of at most "
        f"{BLOOM_RPP} rows, written in {time.perf_counter() - t0:.2f} s")

    # what every statement on a store pays before any scan: manifest reads
    # (JSON holding the partition list, statistics and the table's
    # string dictionaries)
    manifests = {}
    for name in tpch.SCHEMAS:
        mpath = os.path.join(root, name, "_manifests",
                             f"v{w.store.current_version(name)}.json")
        t0 = time.perf_counter()
        w.store.read_manifest(name)
        manifests[name] = {"bytes": os.path.getsize(mpath),
                           "parse_ms": (time.perf_counter() - t0) * 1e3}
    report["manifests"] = manifests
    log(f"[store] manifest bytes and one read's ms per table: {manifests}")
    del w, wb

    # ---------------------------------------- cold, pool and cache tiers
    tiers, store_res = {}, {}
    for q in STORE_QUERIES:
        sql = tpch.QUERIES[q]
        want, ram_fired = ram[q]
        sharedcache.drop_store_scope(root)
        rows = []
        s = None
        for tier in STORE_TIERS:
            if tier != "scan cache":
                s = ct.Session(cfg)
                check(all(t.cold for t in s.catalog.tables.values()),
                      "a fresh session registered a table warm")
            pool = BUF.pool_for(s)
            r0, p0, c0 = dict(reads), pool.snapshot(), s.counters.snapshot()
            res, ms, counts = kit.counted_run(s, sql)
            r1, p1, c1 = dict(reads), pool.snapshot(), s.counters.snapshot()
            got = physical(res)
            same(got, oracle(raw, q, D), f"{q} from the store ({tier}) vs "
                 "the numpy oracle")
            same(got, want, f"{q} from the store ({tier}) vs the RAM path")
            fired = {k for k, v in counts.items() if v}
            check(fired == ram_fired, f"{q} from the store ({tier}): "
                  f"launches {counts}, the RAM path launched "
                  f"{sorted(ram_fired)}")
            nbytes, secs = r1["bytes"] - r0["bytes"], r1["s"] - r0["s"]
            scan_bytes = sum(X._nbytes(v)
                             for v in s._store_scan_cache.values())
            row = {"tier": tier, "ms": ms, "launches": counts,
                   "partitions_read": r1["parts"] - r0["parts"],
                   "decoded_bytes": nbytes, "read_decode_s": secs,
                   "decode_mb_s": nbytes / 1e6 / secs if secs else None,
                   "manifest_reads": r1["manifests"] - r0["manifests"],
                   "manifest_ms": (r1["manifest_s"] - r0["manifest_s"]) * 1e3,
                   "footer_reads": r1["footers"] - r0["footers"],
                   "footer_ms": (r1["footer_s"] - r0["footer_s"]) * 1e3,
                   **{f"pool_{k}": p1[k] - p0[k] for k in
                      ("hits", "misses", "admits", "evictions",
                       "refusals")},
                   "pool_resident_bytes": p1["bytes"],
                   "scan_cache_bytes": scan_bytes,
                   **{f"scan_cache_{k}":
                      c1.get(f"store_scan_cache_{k}", 0)
                      - c0.get(f"store_scan_cache_{k}", 0)
                      for k in ("hits", "refusals")}}
            rows.append(row)
            log(f"[store] {q} {tier}: {ms:.3f} ms, {row['partitions_read']} "
                f"partition(s) read and decoded ({nbytes} bytes in "
                f"{secs:.3f} s"
                + (f", {row['decode_mb_s']:.1f} MB/s" if secs else "")
                + f"), {row['manifest_reads']} manifest read(s) in "
                f"{row['manifest_ms']:.3f} ms, {row['footer_reads']} footer "
                f"read(s) in {row['footer_ms']:.3f} ms, pool hits "
                f"{row['pool_hits']} misses "
                f"{row['pool_misses']} admits {row['pool_admits']} "
                f"evictions {row['pool_evictions']} refusals "
                f"{row['pool_refusals']}, resident {p1['bytes']} bytes, "
                f"scan-cache hits {row['scan_cache_hits']} refusals "
                f"{row['scan_cache_refusals']} holding {scan_bytes} bytes, "
                f"launches {counts}; equal to the numpy oracle and the RAM "
                "path")
            check(p1["bytes"] + scan_bytes <= cfg.bufferpool.max_bytes,
                  f"{q} {tier}: pool and scan cache hold "
                  f"{p1['bytes'] + scan_bytes} device bytes, over "
                  f"bufferpool.max_bytes {cfg.bufferpool.max_bytes}")
        cold, admit, served, cached = rows
        check(cold["partitions_read"] > 0 and cold["pool_admits"] == 0,
              f"{q} cold tier: {cold}")
        check(admit["pool_admits"] > 0, f"{q}: the pool admitted nothing")
        check(served["pool_hits"] > 0, f"{q}: the pool served nothing")
        # the repeat is served from device memory: the scan cache where
        # its entry fits beside the pool in max_bytes, else the pool
        check(cached["partitions_read"] == 0
              and cached["scan_cache_hits"] + cached["pool_hits"] > 0,
              f"{q} scan-cache tier: {cached}")
        # every kernel call of one more run, held against its plain version
        held(f"{q} from the store", lambda: s.sql(sql))
        tiers[q] = rows
        store_res[q] = got
        del s
    report["tiers"] = tiers

    # ------------------------------------------------------------ pruning
    s = ct.Session(cfg)
    prune = {}
    for q in ("q1", "q3"):
        sql = re.sub(r"\blineitem\b", "lineitem_p", tpch.QUERIES[q])
        reps = store_scan_reports(s, sql)
        sizes = []
        res = held(f"{q} on lineitem_p", lambda: s.sql(sql), sizes)
        got = physical(res)
        same(got, store_res[q], f"{q} on lineitem_p vs unpartitioned")
        res, ms, counts = kit.counted_run(s, sql)
        same(physical(res), store_res[q], f"{q} on lineitem_p (counted run)")
        prune[q] = {"scans": reps, "kernel_inputs": sizes, "ms": ms,
                    "launches": counts}
        log(f"[prune] {q} on lineitem_p: {ms:.3f} ms, scans {reps}, kernel "
            f"inputs {sizes}, launches {counts}; equal to the "
            f"unpartitioned store run")
    li_p = next(r for r in prune["q3"]["scans"] if r["table"] == "lineitem_p")
    check(li_p["skipped_minmax"] > 0, f"Q3 on lineitem_p pruned nothing: "
          f"{li_p}")
    key = int(cu["c_custkey"][len(cu["c_custkey"]) // 3])
    sql = (f"select c_custkey, c_acctbal, c_mktsegment from customer_b "
           f"where c_custkey = {key}")
    reps = store_scan_reports(s, sql)
    res, ms, counts = kit.counted_run(s, sql)
    same(physical(res), physical_of(
        cu, [f for f in b_fields if f.name != "c_nationkey"],
        rows=np.nonzero(cu["c_custkey"] == key)[0]),
        "point lookup on customer_b vs numpy")
    check(reps[0]["skipped_bloom"] > 0, f"the bloom pruned nothing: {reps}")
    prune["point"] = {"sql": sql, "scans": reps, "ms": ms}
    log(f"[prune] {sql}: {ms:.3f} ms, scans {reps}; equal to numpy")
    report["prune"] = prune
    del s

    # --------------------------------------------------------- join index
    jx = ct.Session()
    copy_tables(ram_session, jx, names)
    for n in names:
        jx.device_table(n)
    jix = {}
    for q in ("q3", "q5"):
        sql = tpch.QUERIES[q]
        plan = _optimize(Binder(jx.catalog).bind_query(parse_sql(sql)), jx)
        specs = JI.jix_specs_of(plan)
        runs = []
        for i in range(2):
            c0 = jx.counters.snapshot()
            res, ms, counts = kit.counted_run(jx, sql)
            c1 = jx.counters.snapshot()
            same(physical(res), ram[q][0], f"{q} join-index run {i + 1}")
            runs.append({"ms": ms, "launches": counts, **{
                k: c1.get(f"join_index_{k}", 0) - c0.get(f"join_index_{k}", 0)
                for k in ("builds", "hits")}})
        if specs:
            check(runs[1]["hits"] == len(specs) and runs[1]["builds"] == 0,
                  f"{q}: the second run did not use the cached index: "
                  f"{runs}")
        sorts = []
        for spec in specs:
            # the build sort the cached index stands in for, on the device,
            # and the cached index held equal to it
            cols = jx.device_table(spec.table)
            rows_ = jx.catalog.table(spec.table).num_rows
            keys = [cols[p] for p in spec.phys]
            bsel = torch.arange(keys[0].shape[0], device=kit.dev) < rows_
            order, skeys, _ = K.build_sort(keys, bsel, spec.bits)
            idx = JI._cached_index(jx, spec)
            check(torch.equal(idx["order"], order)
                  and torch.equal(idx["skeys"], skeys),
                  f"{q}: the cached index of {spec.key} differs from "
                  "build_sort")
            ms = kit.timer.device(lambda: K.build_sort(keys, bsel, spec.bits))
            sorts.append({"index": spec.key, "rows": rows_,
                          "build_sort_device_ms": ms})
        eligible = sum(1 for n in all_nodes(plan)
                       if getattr(n, "_jix", None) is not None)
        jix[q] = {"runs": runs, "indexed_joins": eligible,
                  "build_sorts": sorts}
        log(f"[joinindex] {q}: {eligible} join(s) annotated with a cached index "
            f"(build: a bare scan of a whole RAM table); "
            f"run 1 {runs[0]['ms']:.3f} ms ({runs[0]['builds']} index "
            f"build(s)), run 2 {runs[1]['ms']:.3f} ms ({runs[1]['hits']} "
            f"cached index hit(s)); build sorts the index removes: {sorts}")
    check(jix["q5"]["indexed_joins"] > 0, "Q5 has no join-index join")
    report["join_index"] = jix
    del jx

    # ----------------------------------------------------------- DML last
    report["dml"] = _storage_dml(kit, raw, cfg, root)
    return report


def _storage_dml(kit, raw, cfg, root) -> dict:
    """DML at scale against numpy on the same data; then a fresh session
    must see every change."""
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch.types import date_to_days as D

    od, li = raw["orders"], raw["lineitem"]
    oschema = tpch.SCHEMAS["orders"]
    n_ord = len(od["o_orderkey"])
    s = ct.Session(cfg)
    walls = {}

    def run(sql, want_status=None):
        kit.sync()
        t0 = time.perf_counter()
        res = s.sql(sql)
        kit.sync()
        walls[sql] = (time.perf_counter() - t0) * 1e3
        if want_status is not None:
            check(res == want_status, f"{sql!r}: {res!r}, numpy says "
                  f"{want_status!r}")
        log(f"[dml] {walls[sql]:.1f} ms: {sql} -> {res}")
        return res

    def agg(sql):
        got = physical(s.sql(sql))
        return {k: v.tolist()[0] for k, v in got.items()}

    tmp = os.path.dirname(root)
    lines = tbl_lines(od, oschema)
    path_in = os.path.join(tmp, "orders.tbl")
    with open(path_in, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    cols = ddl_columns(oschema)
    every = ", ".join(f.name for f in oschema.fields)
    want_orders = physical_of(od, oschema.fields)

    # COPY FROM, COPY TO, and back
    run(f"create table orders_load ({cols})")
    run(f"copy orders_load from '{path_in}' with delimiter '|'",
        f"COPY {n_ord}")
    same(physical(s.sql(f"select {every} from orders_load")), want_orders,
         "orders_load after COPY FROM vs numpy")
    path_out = os.path.join(tmp, "orders_out.tbl")
    run(f"copy orders_load to '{path_out}' with delimiter '|'",
        f"COPY {n_ord}")
    with open(path_in, "rb") as a, open(path_out, "rb") as b:
        check(a.read() == b.read(), "COPY TO wrote other bytes than the "
              "loaded file")
    run(f"create table orders_back ({cols})")
    run(f"copy orders_back from '{path_out}' with delimiter '|'",
        f"COPY {n_ord}")
    same(physical(s.sql(f"select {every} from orders_back")), want_orders,
         "orders_back after COPY TO and FROM vs numpy")

    # single-row error handling: four bad lines among SREH_ROWS good ones
    bad = ["oops|" + lines[0].split("|", 1)[1],                # bad bigint
           "|".join(lines[1].split("|")[:3] + ["12x.5"]
                    + lines[1].split("|")[4:]),               # bad decimal
           "|".join(lines[2].split("|")[:-1]),                 # short row
           "|".join(lines[3].split("|")[:4] + ["1995-13-45"]
                    + lines[3].split("|")[5:])]               # bad date
    n_sreh = min(SREH_ROWS, n_ord // 2)
    sreh = lines[:n_sreh // 2] + bad[:2] + lines[n_sreh // 2:n_sreh] \
        + bad[2:]
    bad_lines = {n_sreh // 2 + 1, n_sreh // 2 + 2, n_sreh + 3, n_sreh + 4}
    path_rej = os.path.join(tmp, "orders_rej.tbl")
    with open(path_rej, "w") as fh:
        fh.write("\n".join(sreh) + "\n")
    run(f"create table orders_rej ({cols})")
    run(f"copy orders_rej from '{path_rej}' with delimiter '|' segment "
        "reject limit 10 log errors",
        f"COPY {n_sreh} (rejected {len(bad)} rows)")
    check({e["line"] for e in s.copy_errors["orders_rej"]} == bad_lines,
          f"rejected lines {s.copy_errors['orders_rej']}")
    same(physical(s.sql(f"select {every} from orders_rej")),
         physical_of(od, oschema.fields, rows=np.arange(n_sreh)),
         "orders_rej vs numpy")

    # CREATE TABLE AS of Q3's join, INSERT ... SELECT
    want_q3 = q3_groups(raw, D)
    run("create table q3_all as select l_orderkey, sum(l_extendedprice * "
        "(1 - l_discount)) as revenue, o_orderdate, o_shippriority from "
        "customer, orders, lineitem where c_mktsegment = 'BUILDING' and "
        "c_custkey = o_custkey and l_orderkey = o_orderkey and o_orderdate "
        "< date '1995-03-15' and l_shipdate > date '1995-03-15' group by "
        "l_orderkey, o_orderdate, o_shippriority",
        f"SELECT {len(want_q3['l_orderkey'])}")
    same(physical(s.sql("select l_orderkey, revenue, o_orderdate, "
                        "o_shippriority from q3_all order by l_orderkey")),
         want_q3, "q3_all vs numpy")
    late = li["l_shipdate"] > D("1998-06-01")
    run("create table li_late (l_orderkey bigint, l_extendedprice "
        "decimal(15,2), l_shipdate date)")
    run("insert into li_late select l_orderkey, l_extendedprice, l_shipdate "
        "from lineitem where l_shipdate > date '1998-06-01'",
        f"INSERT {int(late.sum())}")
    same(physical(s.sql("select l_orderkey, l_extendedprice, l_shipdate "
                        "from li_late")),
         {"l_orderkey": li["l_orderkey"][late],
          "l_extendedprice": _cents(li["l_extendedprice"])[late],
          "l_shipdate": li["l_shipdate"][late]}, "li_late vs numpy")

    # UPDATE and DELETE of the store's own tables
    upd = od["o_orderdate"] < D("1995-01-01")
    price = want_orders["o_totalprice"]
    new_price = np.where(upd, price * 2, price)
    run("update orders set o_totalprice = o_totalprice * 2 where "
        "o_orderdate < date '1995-01-01'", f"UPDATE {int(upd.sum())}")
    same(physical(s.sql("select o_orderkey, o_totalprice from orders")),
         {"o_orderkey": od["o_orderkey"], "o_totalprice": new_price},
         "orders after UPDATE vs numpy")
    gone = li["l_shipdate"] > D("1998-08-01")
    keep_cents = _cents(li["l_extendedprice"])[~gone]
    run("delete from lineitem where l_shipdate > date '1998-08-01'",
        f"DELETE {int(gone.sum())}")
    want_li = {"c": int((~gone).sum()), "s": int(keep_cents.sum())}
    check(agg("select count(*) as c, sum(l_extendedprice) as s from "
              "lineitem") == want_li, "lineitem after DELETE vs numpy")

    # a fresh session sees every change
    del s
    s = ct.Session(cfg)
    check(all(t.cold for t in s.catalog.tables.values()),
          "a fresh session registered a table warm")
    want_after = {
        "orders": {"c": n_ord, "s": int(new_price.sum())},
        "lineitem": want_li,
        "orders_load": {"c": n_ord, "s": int(price.sum())},
        "orders_back": {"c": n_ord, "s": int(price.sum())},
        "orders_rej": {"c": n_sreh, "s": int(price[:n_sreh].sum())},
        "q3_all": {"c": len(want_q3["l_orderkey"]),
                   "s": int(want_q3["revenue"].sum())},
        "li_late": {"c": int(late.sum()),
                    "s": int(_cents(li["l_extendedprice"])[late].sum())},
    }
    value = {"lineitem": "l_extendedprice", "q3_all": "revenue",
             "li_late": "l_extendedprice"}
    for table, want in want_after.items():
        got = agg(f"select count(*) as c, sum({value.get(table, 'o_totalprice')}"
                  f") as s from {table}")
        check(got == want, f"{table} in a fresh session: {got}, numpy "
              f"{want}")
    log(f"[dml] a fresh session sees every change: {want_after}")
    return {"walls_ms": walls, "after": want_after}


# ------------------------------------------------------------- the phases

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--ds-scale", type=float, default=DS_SCALE,
                    help="tpcds-lite scale (100: 3M store_sales rows; a "
                    "small scale makes a quick check)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace TPC-H Q1/Q3/Q5, TPC-DS q36/q98 and the "
                    "window query with torch.profiler and write each "
                    "device-time table under chiprun_out/")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cloudberry_tpu_torch as ct
    from cloudberry_tpu_torch import tpch
    from cloudberry_tpu_torch import tpcds
    from cloudberry_tpu_torch.catalog import carry
    from cloudberry_tpu_torch.exec import cuda_kernels as CK
    from cloudberry_tpu_torch.exec import executor as X
    from cloudberry_tpu_torch.exec import kernels as K
    from cloudberry_tpu_torch.types import date_to_days

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    CK.build(verbose=True)
    log(f"[build] kernels built in {time.perf_counter() - t0:.2f} s")

    originals = {k: getattr(CK, k) for k in CK.LAUNCHES}
    launches = {k: 0 for k in CK.LAUNCHES}   # summed over counted runs

    report = {}     # per kernel: the largest difference from plain seen

    def compare(name, what, args_, kernel, plain, quiet=False):
        got = kernel(*args_)
        want = plain(*args_)
        torch.cuda.synchronize()
        exact = [(g, w) for g, w in zip(got, want)
                 if not w.dtype.is_floating_point]
        floats = [(g, w) for g, w in zip(got, want)
                  if w.dtype.is_floating_point]
        check(max_abs_err(torch, *zip(*exact)) == 0,
              f"{name} {what}: integer outputs differ from plain")
        err = max_abs_err(torch, *zip(*floats)) if floats else 0.0
        # float sums: the kernel adds in another order than index_add_
        tol = 1e-9 * max([1.0] + [float(w.abs().max()) for _, w in floats
                                  if w.numel()])
        check(err <= tol, f"{name} {what}: float outputs differ from plain "
              f"(max abs err {err}, tolerance {tol})")
        if not quiet:
            log(f"[kernel] {name} {what}: equal to the plain version "
                f"(max abs err {err})")
        report.setdefault(name, {"max_abs_err": 0.0})
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)

    def probe_outputs(fn, a):
        """(matched, *payload columns, duplicate flag) of one probe-join
        call on a fresh zeroed flag slot."""
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        matched, out = fn(*a[:5], flag)
        return (matched, *out, flag)

    plains = {"dense_agg": CK.dense_agg_plain,
              "probe_join": CK.probe_join_plain,
              "sorted_seg": CK.sorted_seg_plain}
    held = {k: 0 for k in CK.LAUNCHES}   # calls held against plain

    def holding(name, what, sizes=None):
        """A kernel wrapper that also holds each call against the plain
        version on the same inputs (a warm-up run's calls); ``sizes``, if
        given, collects each call's input sizes."""
        def wrapped(*a):
            if sizes is not None:
                sizes.append(f"{name} {input_sizes(name, a)}")
            out = originals[name](*a)
            if name == "probe_join":
                compare(name, what, a,
                        lambda *x: probe_outputs(originals[name], x),
                        lambda *x: probe_outputs(plains[name], x), True)
            else:
                compare(name, what, a, originals[name], plains[name], True)
            held[name] += 1
            return out
        return wrapped

    def input_sizes(name, a):
        if name == "dense_agg":
            return f"N={a[0].shape[0]} cells={a[4]}"
        if name == "probe_join":
            return f"B={a[1].shape[0]} N={a[3].shape[0]}"
        return f"N={a[0].shape[1]} groups={int(a[3])} cap={a[4]}"

    def counted_run(session, sql):
        """One run with the launch counts zeroed just before and read just
        after: (result, wall ms, launches), launches added to the totals."""
        torch.cuda.synchronize()
        for k in CK.LAUNCHES:
            CK.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        res = session.sql(sql)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = dict(CK.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        return res, ms, counts

    def cpu_run(session, sql):
        """The port's CPU run, and which kernels' wrappers it called."""
        called = {k: 0 for k in CK.LAUNCHES}

        def counting(name):
            def wrapped(*a):
                called[name] += 1
                return originals[name](*a)
            return wrapped

        for k in CK.LAUNCHES:
            setattr(CK, k, counting(k))
        try:
            return session.sql(sql), called
        finally:
            for k, fn in originals.items():
                setattr(CK, k, fn)

    # ----------------------------------------------------------- 3. TPC-H
    t0 = time.perf_counter()
    raw = tpch.generate(args.sf, SEED)
    names = ["region", "nation", "supplier", "customer", "orders",
             "lineitem"]
    gpu = ct.Session()
    tpch.load_tables(gpu, tpch.SCHEMAS, tpch.DIST_KEYS, raw, names)
    cpu = ct.Session(device="cpu")
    copy_tables(gpu, cpu, names)
    log(f"[data] TPC-H sf={args.sf} seed={SEED}: "
        f"{gpu.catalog.table('lineitem').num_rows} lineitem rows, "
        f"{time.perf_counter() - t0:.1f} s to generate and load")

    # record the inputs every kernel call of the warm-up runs receives
    recorded: dict[str, list] = {k: [] for k in CK.LAUNCHES}
    current = [None]

    def snap(x):
        if torch.is_tensor(x):
            return x.clone()
        return [snap(y) for y in x] if isinstance(x, list) else x

    def recorder(name):
        def wrapped(*a):
            if a[1].device.type == "cuda":
                recorded[name].append((current[0], [snap(x) for x in a]))
            return originals[name](*a)
        return wrapped

    # the probe-join operator as the Lowerer calls it on Q5, to count its
    # device kernels later
    operator_calls = []
    real_gate = X.Lowerer._probe_join_kernel

    def gate_recorder(self, *a):
        out = real_gate(self, *a)
        if out is not None:     # the join took the probe-join kernel
            operator_calls.append((self, a))
        return out

    query_ms = {}
    ram = {}    # per query: (physical result, kernels launched)
    for q in ("q1", "q3", "q5"):
        sql = tpch.QUERIES[q]
        for k in CK.LAUNCHES:
            setattr(CK, k, recorder(k))
        if q == "q5":
            X.Lowerer._probe_join_kernel = gate_recorder
        current[0] = q
        t0 = time.perf_counter()
        gpu.sql(sql)
        warm_ms = (time.perf_counter() - t0) * 1e3
        for k, fn in originals.items():
            setattr(CK, k, fn)
        X.Lowerer._probe_join_kernel = real_gate
        res, ms, counts = counted_run(gpu, sql)
        query_ms[q] = [ms]
        fired = {k for k, v in counts.items() if v > 0}
        check(EXPECTED[q] <= fired,
              f"{q}: kernels {sorted(EXPECTED[q])} expected, launches "
              f"{counts}")
        got = physical(res)
        ram[q] = (got, fired)
        same(got, oracle(raw, q, date_to_days), f"{q} vs numpy oracle")
        same(got, physical(cpu.sql(sql)), f"{q} vs the port on the CPU")
        for _ in range(QUERY_RUNS - 1):    # more runs for the spread
            t0 = time.perf_counter()
            gpu.sql(sql)
            torch.cuda.synchronize()
            query_ms[q].append((time.perf_counter() - t0) * 1e3)
        log(f"[query] {q}: {np.median(query_ms[q]):.3f} ms median of "
            f"{QUERY_RUNS} runs ({min(query_ms[q]):.3f}-"
            f"{max(query_ms[q]):.3f}; first run, tables uploaded: "
            f"{warm_ms:.1f} ms), {len(next(iter(got.values())))} rows, "
            f"launches {counts}, equal to the numpy oracle and the CPU run")


    # ---------------------------------------------------------- 4. TPC-DS
    t0 = time.perf_counter()
    ds_raw = tpcds.generate(args.ds_scale, DS_SEED)
    gds = ct.Session()
    tpch.load_tables(gds, tpcds.SCHEMAS, tpcds.DIST_KEYS, ds_raw)
    del ds_raw
    cds = ct.Session(device="cpu")
    copy_tables(gds, cds, list(tpcds.SCHEMAS))
    log(f"[data] TPC-DS (tpcds-lite) scale={args.ds_scale} seed={DS_SEED}: "
        f"{gds.catalog.table('store_sales').num_rows} store_sales, "
        f"{gds.catalog.table('catalog_sales').num_rows} catalog_sales, "
        f"{gds.catalog.table('web_sales').num_rows} web_sales, "
        f"{gds.catalog.table('inventory').num_rows} inventory rows, "
        f"{time.perf_counter() - t0:.1f} s to generate and load")
    ds_ms, ds_launches = {}, {}
    for q in sorted(tpcds.QUERIES, key=lambda q: int(q[1:])):
        sql = tpcds.QUERIES[q]
        for k in CK.LAUNCHES:
            setattr(CK, k, holding(k, f"TPC-DS {q} main-path input"))
        t0 = time.perf_counter()
        gds.sql(sql)
        warm_ms = (time.perf_counter() - t0) * 1e3
        for k, fn in originals.items():
            setattr(CK, k, fn)
        res, ms, counts = counted_run(gds, sql)
        want, called = cpu_run(cds, sql)
        check({k for k, v in counts.items() if v} ==
              {k for k, v in called.items() if v},
              f"TPC-DS {q}: launches {counts} on the card, kernel calls "
              f"{called} on the CPU")
        check(any(counts.values()), f"TPC-DS {q}: no kernel launched")
        err = same_nulls(with_nulls(res), with_nulls(want),
                         f"TPC-DS {q} vs the port on the CPU")
        ds_ms[q] = [ms]
        runs = QUERY_RUNS if q in WINDOWED else 1
        for _ in range(runs - 1):
            t0 = time.perf_counter()
            gds.sql(sql)
            torch.cuda.synchronize()
            ds_ms[q].append((time.perf_counter() - t0) * 1e3)
        ds_launches[q] = counts
        log(f"[tpcds] {q}: {np.median(ds_ms[q]):.3f} ms median of "
            f"{len(ds_ms[q])} run(s) ({min(ds_ms[q]):.3f}-"
            f"{max(ds_ms[q]):.3f}; warm-up {warm_ms:.1f} ms), "
            f"{res.num_rows()} rows, launches {counts}, equal to the CPU "
            f"run (largest float difference {err})")
    log(f"[tpcds] kernel calls of the warm-up runs held against their plain "
        f"versions: {held}")

    # ------------------------------------------------- 5. windows at scale
    window = {}
    for case, where in (("full", "d_year >= 1998"),
                        ("empty selection", "d_year = 1900"),
                        ("one row", "ss_ticket_number = 777")):
        sql = tpcds.WINDOW_QUERY.format(where=where)
        gds.sql(sql)                  # warm-up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res, ms, counts = counted_run(gds, sql)
        peak = torch.cuda.max_memory_allocated()
        want, _ = cpu_run(cds, sql)
        err = same_nulls(with_nulls(res), with_nulls(want),
                         f"window query ({case}) vs the port on the CPU")
        walls = [ms]
        for _ in range(QUERY_RUNS - 1 if case == "full" else 0):
            t0 = time.perf_counter()
            gds.sql(sql)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        check((res.num_rows() > 0) if case == "full" else
              res.num_rows() == {"empty selection": 0, "one row": 1}[case],
              f"window query ({case}): {res.num_rows()} rows")
        window[case] = {"rows": res.num_rows(), "ms": walls,
                        "peak_bytes": peak, "resident_bytes": base,
                        "launches": counts}
        log(f"[window] {case}: {res.num_rows()} rows, "
            f"{np.median(walls):.3f} ms median of {len(walls)} run(s) "
            f"({min(walls):.3f}-{max(walls):.3f}), peak device memory "
            f"{peak / 2**30:.3f} GiB ({base / 2**30:.3f} GiB resident "
            f"before), launches {counts}, equal to the CPU run (largest "
            f"float difference {err})")
    del cds

    # ---------------------------------------------------------- 6. growth
    pk_, pv_, bk_, bv_ = skew_join_tables(SKEW_ROWS)
    gsk = ct.Session()
    F = carry.field
    carry.load_encoded(gsk, "f", [F("k", "int64", 0, False),
                                  F("v", "int64", 0, False)],
                       {"k": pk_, "v": pv_})
    carry.load_encoded(gsk, "d", [F("k", "int64", 0, False),
                                  F("w", "int64", 0, False)],
                       {"k": bk_, "w": bv_})
    sql = "select count(*) as c, sum(f.v + d.w) as s from f join d on f.k = d.k"
    res, ms, counts = counted_run(gsk, sql)
    want_c, want_s = skew_join_oracle(pk_, pv_, bk_, bv_)
    got = physical(res)
    check(got["c"].tolist() == [want_c] and got["s"].tolist() == [want_s],
          f"skew join: {got} against numpy count {want_c}, sum {want_s}")
    check(gsk.growth_events > 0, "skew join: the pair buffer never grew")
    growth = {"probe_rows": SKEW_ROWS, "pairs": want_c,
              "growth_events": gsk.growth_events, "ms": ms,
              "launches": counts}
    log(f"[growth] skew join: {want_c} pairs from {SKEW_ROWS} probe rows, "
        f"{gsk.growth_events} growth(s) of the pair buffer, {ms:.1f} ms "
        f"with the retries, launches {counts}, equal to numpy")
    del gsk
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    timer = Timer(torch, flush, REPS)

    # --------------------------------------------------------- 7. storage
    t0 = time.perf_counter()
    held_before = dict(held)
    store = storage_phase(SimpleNamespace(
        torch=torch, dev=dev, sync=torch.cuda.synchronize,
        counted_run=counted_run, holding=holding, originals=originals,
        timer=timer), raw, ram, gpu, names)
    store["s"] = time.perf_counter() - t0
    store["held"] = {k: held[k] - held_before[k] for k in held}
    log(f"[store] kernel calls of the store path held against their plain "
        f"versions: {store['held']}; storage phase: {store['s']:.1f} s")

    # --------------------------------------------------------- 8. kernels
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand_int(lo, hi, shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def rand_sel(n, p=0.9):
        return torch.rand(n, generator=gen, device=dev) < p

    # dense_agg -----------------------------------------------------------
    N = 6_001_215
    for q, a in recorded["dense_agg"]:
        compare("dense_agg", f"{q} main-path input (N={a[0].shape[0]}, "
                f"K={a[1].shape[0]}, cells={a[4]})", a, CK.dense_agg,
                CK.dense_agg_plain)

    def no_floats(n):
        return torch.zeros((0, n), dtype=torch.float64, device=dev)

    dense_cases = {
        f"N={N} K={k} cells={cells}": (
            rand_int(0, cells, (N,), torch.int32),
            rand_int(0, 10_000_000, (k, N)), no_floats(N), rand_sel(N),
            cells)
        for cells, k in ((6, 7), (25, 1), (300, 1), (4096, 7))}
    one_cell = f"N={N} K=7 cells=6, every row in cell 2"
    dense_cases[one_cell] = (
        torch.full((N,), 2, dtype=torch.int32, device=dev),
        rand_int(0, 10_000_000, (7, N)), no_floats(N),
        torch.ones(N, dtype=torch.bool, device=dev), 6)
    dense_cases[f"N={N} Ki=1 Kf=2 cells=25 (float sums)"] = (
        rand_int(0, 25, (N,), torch.int32), rand_int(0, 10_000, (1, N)),
        torch.randn((2, N), generator=gen, device=dev, dtype=torch.float64),
        rand_sel(N), 25)
    for what, a in dense_cases.items():
        compare("dense_agg", what, a, CK.dense_agg, CK.dense_agg_plain)
    big = (1 << 62) + 12345
    edge_n = 1001
    edges = {
        "empty selection": (rand_int(0, 6, (edge_n,), torch.int32),
                            rand_int(-5, 5, (3, edge_n)),
                            torch.zeros((0, edge_n), dtype=torch.float64,
                                        device=dev),
                            torch.zeros(edge_n, dtype=torch.bool,
                                        device=dev), 6),
        "ragged N, near-overflow values (wraparound)": (
            rand_int(-1, 8, (edge_n,), torch.int32),
            torch.stack([torch.full((edge_n,), big, device=dev),
                         torch.full((edge_n,), -big, device=dev),
                         rand_int(-(1 << 62), 1 << 62, (edge_n,))]),
            torch.zeros((0, edge_n), dtype=torch.float64, device=dev),
            rand_sel(edge_n), 6),
        "count only (no value rows)": (
            rand_int(0, 5, (edge_n,), torch.int32),
            torch.zeros((0, edge_n), dtype=torch.int64, device=dev),
            torch.zeros((0, edge_n), dtype=torch.float64, device=dev),
            rand_sel(edge_n), 5),
        "float values": (rand_int(0, 25, (edge_n,), torch.int32),
                         rand_int(-100, 100, (1, edge_n)),
                         torch.randn((2, edge_n), generator=gen,
                                     device=dev, dtype=torch.float64),
                         rand_sel(edge_n), 25),
    }
    for what, a in edges.items():
        compare("dense_agg", what, a, CK.dense_agg, CK.dense_agg_plain)

    # probe_join ----------------------------------------------------------
    def probe_compare(what, a):
        compare("probe_join", what, a,
                lambda *x: probe_outputs(CK.probe_join, x),
                lambda *x: probe_outputs(CK.probe_join_plain, x))
        return probe_outputs(CK.probe_join, a)

    for q, a in recorded["probe_join"]:
        probe_compare(f"{q} main-path input (B={a[1].shape[0]}, "
                      f"N={a[3].shape[0]}, keys={len(a[0])}, "
                      f"P={len(a[4])})", a)

    def probe_case(b, n, kind="int64", pay=(torch.int64, torch.int32),
                   bsel_p=0.9, psel_p=0.9, dup=False):
        """Raw key columns of a kind (unique build keys, probe keys drawn
        from four times their range), selections, payload columns."""
        span = 4 * b
        ids = torch.randperm(span, generator=gen, device=dev)[:b]
        pids = rand_int(0, span, (n,))
        if kind == "int64":
            bk, pk = [ids], [pids]
        elif kind == "int32":
            bk, pk = [ids.to(torch.int32)], [pids.to(torch.int32)]
        elif kind == "two_column":
            bk = [ids // 7, (ids % 7).to(torch.int32)]
            pk = [pids // 7, (pids % 7).to(torch.int32)]
        elif kind == "out_of_range":
            bk, pk = [ids], [rand_int(-span, 2 * span, (n,))]
        elif kind == "negative_int64":
            bk, pk = [ids * -(10 ** 12 + 7919)], [pids * -(10 ** 12 + 7919)]
        elif kind == "bool":
            bk = [torch.tensor([True, False], device=dev)[:b]]
            pk = [rand_sel(n, 0.5)]
        elif kind == "float64":
            bk = [1.0 + ids.to(torch.float64) * 2.0 ** -52]
            pk = [1.0 + pids.to(torch.float64) * 2.0 ** -52]
        elif kind == "span_2_32":   # spans 2^16 x 2^16: product 2^32
            bk = [rand_int(0, 1 << 16, (b,), torch.int32) for _ in "12"]
            pk = [rand_int(-5, (1 << 16) + 5, (n,), torch.int32)
                  for _ in "12"]
            for bc, pc in zip(bk, pk):
                bc[0], bc[1] = 0, 65535
                pc[:b] = bc
        else:
            raise KeyError(kind)
        bsel, psel = rand_sel(b, bsel_p), rand_sel(n, psel_p)
        if dup:
            for bc, pc in zip(bk, pk):
                bc[1] = bc[0]
                pc[:5] = bc[0]
            bsel[:2] = True
            psel[:5] = True
        payload = [rand_sel(b, 0.5) if dt == torch.bool else
                   rand_int(-(1 << 30), 1 << 30, (b,), dt) if
                   dt == torch.int32 else
                   rand_int(-(1 << 62), 1 << 62, (b,)) for dt in pay]
        return bk, bsel, pk, psel, payload

    PN = 1_500_000
    LN = gpu.catalog.table("lineitem").num_rows
    probe_large = f"B=2048 N={LN} P=2 (int64 key; int64, int32 payload)"
    probe_cases = {f"B={b} N={PN} P=2": probe_case(b, PN)
                   for b in (5, 25, 2048)}
    probe_cases[probe_large] = probe_case(2048, LN)
    edge_probe = {
        "two-column key": probe_case(300, edge_n, "two_column"),
        "probe keys below and above the build's range":
            probe_case(100, edge_n, "out_of_range"),
        "negative int64 keys": probe_case(200, edge_n, "negative_int64"),
        "int32 key": probe_case(700, edge_n, "int32"),
        "bool key": probe_case(2, edge_n, "bool", bsel_p=1.0),
        "float64 key (sort_key_u64 in the wrapper)":
            probe_case(50, edge_n, "float64"),
        "int32 + int64 + bool payload":
            probe_case(25, edge_n, pay=(torch.int32, torch.int64,
                                        torch.bool)),
        "membership only (no payload)": probe_case(25, edge_n, pay=()),
        "empty build selection": probe_case(25, edge_n, bsel_p=0.0),
        "key spans whose product is 2^32":
            probe_case(64, edge_n, "span_2_32", bsel_p=1.0),
        "duplicate build key": probe_case(25, edge_n, dup=True),
        "duplicate build key, empty probe selection":
            probe_case(25, edge_n, dup=True, psel_p=0.0),
    }
    edge_probe["duplicate build key, empty probe selection"][3].zero_()
    for what, a in {**probe_cases, **edge_probe}.items():
        flag = probe_compare(what, a)[-1]
        want_dup = what.startswith("duplicate build key") and \
            "empty probe" not in what
        check(int(flag) == int(want_dup),
              f"probe_join {what}: duplicate flag {int(flag)}")

    # sorted_seg ----------------------------------------------------------
    for q, a in recorded["sorted_seg"]:
        compare("sorted_seg", f"{q} main-path input (R={a[0].shape[0]}, "
                f"N={a[0].shape[1]}, groups={int(a[3])}, cap={a[4]})", a,
                CK.sorted_seg, CK.sorted_seg_plain)

    def seg_sized(sizes, cap, vals):
        """Groups of the given row counts, back to back from row 0."""
        ends = torch.cumsum(sizes, 0) - 1
        starts = ends - sizes + 1
        z = torch.zeros(cap - sizes.shape[0], dtype=torch.int64, device=dev)
        return (vals, torch.cat([starts, z]), torch.cat([ends, z]),
                torch.tensor(sizes.shape[0], device=dev), cap)

    def seg_case(n_rows, n_groups, cap, vals):
        if n_groups == 0:
            return seg_sized(torch.zeros(0, dtype=torch.int64, device=dev),
                             cap, vals)
        cuts = torch.sort(torch.randperm(n_rows - 1, generator=gen,
                                         device=dev)[:n_groups - 1] + 1
                          ).values
        bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            cuts, torch.tensor([n_rows], device=dev)])
        return seg_sized(bounds[1:] - bounds[:-1], cap, vals)

    q3 = recorded["sorted_seg"][0][1]
    n_q3 = int(q3[3])
    SN, singles = 6_000_000, 60_000
    skewed = (f"skewed: N={SN}, one group of {SN - singles} rows + "
              f"{singles} singletons, cap={SN}")
    seg_edges = {
        f"N={N} groups={n_q3} (Q3's group count)":
            seg_case(N, n_q3, q3[4], rand_int(-(1 << 40), 1 << 40, (1, N))),
        skewed: seg_sized(
            torch.cat([torch.tensor([SN - singles], device=dev),
                       torch.ones(singles, dtype=torch.int64, device=dev)]),
            SN, rand_int(-(1 << 40), 1 << 40, (1, SN))),
        "cap >> groups: N=1000000, 3 groups, cap=4000000":
            seg_case(1_000_000, 3, 4_000_000,
                     rand_int(-(1 << 40), 1 << 40, (2, 1_000_000))),
        "odd cap (unaligned row tails): N=1000003, 1001 groups, "
        "cap=1000003": seg_case(1_000_003, 1001, 1_000_003,
                                rand_int(-(1 << 40), 1 << 40,
                                         (3, 1_000_003))),
        "zero groups": seg_case(edge_n, 0, 64,
                                torch.zeros((2, edge_n), dtype=torch.int64,
                                            device=dev)),
        "ragged N, near-overflow values (wraparound)":
            seg_case(edge_n, 7, 13,
                     torch.stack([torch.full((edge_n,), big, device=dev),
                                  rand_int(-(1 << 62), 1 << 62,
                                           (edge_n,))])),
    }
    for what, a in seg_edges.items():
        compare("sorted_seg", what, a, CK.sorted_seg, CK.sorted_seg_plain)

    # timings: each kernel at the main path's largest input for it, then
    # the extra shapes -----------------------------------------------------

    def timing(shape, kernel, plain, library, bytes_, ops):
        ms = timer.device(kernel)
        check(ms is not None, f"{shape}: the wrapper blocks the host")
        plain_ms = timer.device(plain)
        plain_timing = "device"
        if plain_ms is None:    # the plain version reads the device
            plain_ms, plain_timing = timer.wrapper(plain), "host-inclusive"
        library_ms = timer.device(library)
        check(library_ms is not None, f"{shape}: library call blocks")
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = ops / SCALAR_OPS_PER_S * 1e3
        out = {"shape": shape, "ms": ms, "wrapper_ms": timer.wrapper(kernel),
               "plain_ms": plain_ms, "plain_timing": plain_timing,
               "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        log(f"[time] {shape}: kernel {ms:.4f} ms on the device, "
            f"{out['wrapper_ms']:.4f} ms with the wrapper; plain "
            f"{plain_ms:.4f} ms ({plain_timing}), library call "
            f"{library_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
            f"({out['bound_by']})")
        return out

    def dense_timing(shape, a):
        gid, iv, fv, sel, cells = a
        n, k = gid.shape[0], iv.shape[0] + fv.shape[0]
        keep = sel & (gid >= 0) & (gid < cells)
        g64 = torch.where(keep, gid, cells).to(torch.int64)
        mat = torch.cat([keep.to(torch.int64)[None], iv]).t().contiguous()
        acc = torch.zeros((cells + 1, mat.shape[1]), dtype=torch.int64,
                          device=dev)
        kept = int(keep.sum())
        return timing(
            f"dense_agg {shape}", lambda: CK.dense_agg(*a),
            lambda: CK.dense_agg_plain(*a),
            lambda: acc.index_add_(0, g64, mat),
            # gid and sel of every row, the values of the kept rows only
            # (no other row's values are needed), and the output
            n * (4 + 1) + 8 * k * kept + 8 * (1 + k) * cells,
            kept * (1 + k))

    def seg_timing(shape, a):
        vals, starts, ends, ng, cap = a
        r = vals.shape[0]
        n_groups = int(ng)
        sizes = (ends - starts + 1)[:n_groups]
        n_rows = int(sizes.sum())
        rowgid = torch.repeat_interleave(
            torch.arange(n_groups, device=dev), sizes)
        # the library call's output contract is the kernel's: a count and
        # the sums for every one of the cap slots, zero past n_groups
        seg_src = torch.cat([torch.ones((1, n_rows), dtype=torch.int64,
                                        device=dev), vals[:, :n_rows]]
                            ).t().contiguous()
        return timing(
            f"sorted_seg {shape}", lambda: CK.sorted_seg(*a),
            lambda: CK.sorted_seg_plain(*a),
            lambda: torch.zeros((cap, 1 + r), dtype=torch.int64,
                                device=dev).index_add_(0, rowgid, seg_src),
            # rows read once, 16 B of boundaries per group (the kernel
            # reads none past n_groups), n_groups, the cap-slot outputs
            8 * r * n_rows + 16 * n_groups + 8 + 8 * (1 + r) * cap,
            r * n_rows)

    def probe_timing(shape, a):
        bk, bs, pk, ps, pay = a[:5]
        b, n = bs.shape[0], ps.shape[0]
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        key_bytes = sum(k.element_size() for k in bk)
        pay_bytes = sum(c.element_size() for c in pay)
        n_sel = int(ps.sum())
        # the library call: searchsorted of the raw one-column probe key
        # in the sorted selected build keys, then a gather per column
        bidx = torch.nonzero(bs).flatten()
        order = torch.sort(bk[0][bidx], stable=True).indices
        sk, src = bk[0][bidx][order].contiguous(), bidx[order]
        spay = [c[src].contiguous() for c in pay]
        top = max(sk.shape[0] - 1, 0)

        def library():
            i = torch.searchsorted(sk, pk[0]).clamp(max=top)
            return [c[i] for c in spay]

        # every probe row's selection, match flag and payload values, the
        # key columns of the selected probe rows, the build side
        bytes_ = n * (1 + 1 + pay_bytes) + n_sel * key_bytes \
            + b * (key_bytes + 1 + pay_bytes) + 4
        out = timing(
            f"probe_join {shape}", lambda: CK.probe_join(*a[:5], flag),
            lambda: CK.probe_join_plain(*a[:5], flag), library, bytes_,
            n_sel)   # one table lookup per selected probe row
        # a yardstick: a device copy moving as many bytes (half of them
        # read, half written) under the same timer
        src = torch.empty(bytes_ // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        out["copy_ms"] = timer.device(lambda: dst.copy_(src))
        log(f"[time] probe_join {shape}, a copy of as many bytes: "
            f"{out['copy_ms']:.4f} ms")
        # the operator as it was before the fused kernel (key packing in
        # PyTorch, a zeroed flag, stacked int64 payload, casts back, the
        # flag's compare), with the fused kernel on the prepacked keys,
        # and the executor's sorted lookup (K.join_lookup +
        # K.gather_payload) on the same raw inputs
        names = [f"c{i}" for i in range(len(pay))]

        def old_route():
            ranges = K.key_ranges(bk, bs)
            bp = K.downcast32(K.pack_with_ranges(bk, ranges))
            pp = K.downcast32(K.pack_with_ranges(pk, ranges))
            rows = [c.to(torch.int64) for c in pay]
            stacked = torch.stack(rows) if rows else \
                torch.zeros((0, b), dtype=torch.int64, device=dev)
            has_dup = torch.zeros((1,), dtype=torch.int32, device=dev)
            matched, got = CK.probe_join([bp], bs, [pp], ps, list(stacked),
                                         has_dup)
            return matched, [g.to(c.dtype) for g, c in zip(got, pay)], \
                has_dup[0] != 0

        def sorted_lookup():
            idx, matched, has_dup = K.join_lookup(bk, bs, pk, ps, bits=32)
            return matched, K.gather_payload(dict(zip(names, pay)), idx,
                                              matched), has_dup

        for label, fn in (("old_route", old_route),
                          ("sorted_lookup", sorted_lookup)):
            out[f"{label}_ms"] = timer.device(fn)
            out[f"{label}_wrapper_ms"] = timer.wrapper(fn)
            log(f"[time] probe_join {shape}, {label.replace('_', ' ')}: "
                f"{out[f'{label}_ms']} ms on the device, "
                f"{out[f'{label}_wrapper_ms']:.4f} ms with the host work")
        return out

    def kernels_per_probe_join():
        """Device operations (kernels, fills, copies) of each Q5 probe join
        of the warm-up run, called again on its Lowerer and inputs under
        torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        counts = []
        for low, args in operator_calls:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                check(low._probe_join_kernel(*args) is not None,
                      "a Q5 join left the probe-join kernel")
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type.name == "CUDA"]
            counts.append(len(names))
            log(f"[profile] Q5 probe join (B={args[2].shape[0]}, "
                f"N={args[4].shape[0]}): {len(names)} device "
                f"operation(s): {names}")
        check(counts and all(c == 1 for c in counts),
              f"Q5 probe joins are not one device kernel each: {counts}")
        return counts

    def main_input(name, q, size):
        """The largest input the kernel got on query q's main path."""
        return max((a for qq, a in recorded[name] if qq == q), key=size)

    def dense_size(a):
        return a[1].numel() + a[2].numel()

    # the timer's floor: one tiny op after the L2 flush (the flush leaves
    # dirty lines in L2 that the next op's misses write back)
    one = torch.zeros(1, device=dev)
    timer_floor_ms = timer.device(lambda: one.add_(1))
    log(f"[time] timer floor, one tiny op after the flush: "
        f"{timer_floor_ms:.4f} ms")
    a = main_input("dense_agg", "q1", dense_size)
    report["dense_agg"].update(dense_timing(
        f"Q1: N={a[0].shape[0]} K={a[1].shape[0] + a[2].shape[0]} "
        f"cells={a[4]}", a))
    a = main_input("dense_agg", "q5", dense_size)
    report["dense_agg"]["cases"] = [
        dense_timing(f"Q5: N={a[0].shape[0]} "
                     f"K={a[1].shape[0] + a[2].shape[0]} cells={a[4]}", a),
        dense_timing(one_cell, dense_cases[one_cell])]
    a = main_input("probe_join", "q5",
                   lambda a: a[1].shape[0] * a[3].shape[0])
    report["probe_join"].update(probe_timing(
        f"Q5: B={a[1].shape[0]} N={a[3].shape[0]} P={len(a[4])}", a))
    report["probe_join"]["cases"] = [
        probe_timing(probe_large, probe_cases[probe_large])]
    report["probe_join"]["kernels_per_q5_join"] = kernels_per_probe_join()
    a = main_input("sorted_seg", "q3", lambda a: a[0].numel())
    report["sorted_seg"].update(seg_timing(
        f"Q3: R={a[0].shape[0]} N={a[0].shape[1]} groups={int(a[3])} "
        f"cap={a[4]}", a))
    report["sorted_seg"]["cases"] = [seg_timing(skewed, seg_edges[skewed])]

    # traced last: profiler sessions before the probe-join count above left
    # it with no device events on the card
    if args.profile:
        profile_queries(torch, gpu, {q: tpch.QUERIES[q]
                                     for q in ("q1", "q3", "q5")})
        profile_queries(torch, gds, {
            **{f"tpcds_{q}": tpcds.QUERIES[q] for q in ("q36", "q98")},
            "window_query": tpcds.WINDOW_QUERY.format(
                where="d_year >= 1998")})

    # ---------------------------------------------------------- 9. report
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"cloudberry_tpu_torch/csrc/{CK.SOURCES[name]}",
        "replaces": REPLACES[name], "launches": launches[name],
        **report[name]} for name in CK.LAUNCHES]
    for q, ms in {**query_ms, **{f"tpcds {q}": ms for q, ms in
                                 ds_ms.items() if q in WINDOWED}}.items():
        log(f"[time] {q} wall ms {[round(x, 3) for x in ms]} on {kind} "
            f"({smi})")
    check(all(launches[k] > 0 for k in launches),
          f"a kernel never launched on the main path: {launches}")
    print(smi)
    print(json.dumps({"kernels": kernels, "queries_ms": query_ms,
                      "tpcds_ms": ds_ms, "tpcds_launches": ds_launches,
                      "window": window, "growth": growth, "store": store,
                      "timer_floor_ms": timer_floor_ms, "sf": args.sf,
                      "tpcds_scale": args.ds_scale}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
