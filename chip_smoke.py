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
7. kernels: each kernel, on the inputs the TPC-H path gave it and on
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
8. report: the card line, one JSON line of kernels (launches summed over
   the counted runs of phases 3 to 6), and last the JSON line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

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

    def holding(name, what):
        """A kernel wrapper that also holds each call against the plain
        version on the same inputs (a warm-up run's calls)."""
        def wrapped(*a):
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

    # --------------------------------------------------------- 7. kernels
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

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
    timer = Timer(torch, flush, REPS)

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

    # ---------------------------------------------------------- 8. report
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
                      "window": window, "growth": growth,
                      "timer_floor_ms": timer_floor_ms, "sf": args.sf,
                      "tpcds_scale": args.ds_scale}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
