"""The port's kernel plain versions against the JAX Pallas kernels.

Each Pallas kernel runs as the JAX package's own tests run it on the CPU
(``interpret=True``), with the executor's limb split and recombination
reproduced as its call sites do (executor.py ``_dense_agg_pallas`` and
``_probe_join_pallas``; ``sorted_segment_aggregate`` directly). The port's
wrappers get CPU tensors, so they run their plain versions. Integer results
must be EXACT; float sums agree to rtol 1e-6, because the reference carries
a float value as one f32 row through the MXU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudberry_tpu.exec import kernels as JK
from cloudberry_tpu.exec import pallas_kernels as PK
from cloudberry_tpu_torch.exec import cuda_kernels as CK
from cloudberry_tpu_torch.exec import kernels as TK

BIG = (1 << 62) + 12345


# ----------------------------------------------------------- the reference

def _pad(a, tile):
    pad = (-a.shape[-1]) % tile
    return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)]) if pad else a


def jax_dense(gid, ivals, fvals, sel, cells):
    """executor.py _dense_agg_pallas: limbs in, int64 recombination out."""
    rows = []
    for v in ivals:
        rows.extend(PK.int64_to_agg_limbs(jnp.asarray(v)))
    for v in fvals:
        rows.append(jnp.asarray(v).astype(jnp.float32))
    n = len(gid)
    stacked = jnp.stack(rows) if rows else jnp.zeros((0, n), jnp.float32)
    tiles = PK.dense_agg_tiles_pallas(
        _pad(jnp.asarray(gid, jnp.int32), 2048), _pad(stacked, 2048),
        _pad(jnp.asarray(sel), 2048), n_cells=cells, tile=2048,
        interpret=True)
    counts = jnp.sum(jnp.round(tiles[:, 0]).astype(jnp.int64), axis=0)
    nl = len(PK.AGG_LIMB_BITS)
    isums = [PK.agg_limbs_to_int64(
        [jnp.sum(jnp.round(tiles[:, 1 + k * nl + i]).astype(jnp.int64),
                 axis=0) for i in range(nl)]) for k in range(len(ivals))]
    base = 1 + len(ivals) * nl
    fsums = [jnp.sum(tiles[:, base + k].astype(jnp.float64), axis=0)
             for k in range(len(fvals))]
    return (np.asarray(counts), np.asarray(isums).reshape(len(ivals), cells),
            np.asarray(fsums).reshape(len(fvals), cells))


def jax_probe(bkeys, bsel, pkeys, psel, payload):
    """executor.py _probe_join_pallas: u32 keys, 21/21/22-bit limbs."""
    b, n = len(bkeys), len(pkeys)
    rows = []
    for v in payload:
        rows.extend(PK.int64_to_limbs(jnp.asarray(v)))
    if not rows:
        rows = [jnp.zeros((b,), jnp.float32)]
    match_f, gathered = PK.probe_join_pallas(
        _pad(jnp.asarray(bkeys), 256), _pad(jnp.asarray(bsel), 256),
        _pad(jnp.asarray(pkeys), 1024), _pad(jnp.asarray(psel), 1024),
        _pad(jnp.stack(rows), 256), tile=1024, interpret=True)
    out = [np.asarray(PK.limbs_to_int64(gathered[3 * i, :n],
                                        gathered[3 * i + 1, :n],
                                        gathered[3 * i + 2, :n]))
           for i in range(len(payload))]
    return (np.asarray(match_f[:n] > 0.5),
            np.asarray(out).reshape(len(payload), n),
            bool(jnp.any(match_f > 1.5)), np.asarray(match_f[:n]))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- dense_agg

def _dense_case(rng, n, cells, ki, kf, sel_p=0.8, lo=-10**9, hi=10**9,
                hot=None):
    gid = rng.integers(-1, cells + 1, n).astype(np.int32)
    if hot is not None:  # every row in one cell
        gid[:] = hot
    ivals = rng.integers(lo, hi, (ki, n), dtype=np.int64)
    fvals = rng.normal(size=(kf, n)) * 100.0
    sel = rng.random(n) < sel_p
    return gid, ivals, fvals, sel


DENSE_CASES = {
    "q1_shape": dict(n=5000, cells=6, ki=7, kf=0),
    "q5_shape": dict(n=4500, cells=25, ki=1, kf=0),
    "ragged_n": dict(n=2049, cells=6, ki=2, kf=0),
    "empty_selection": dict(n=3000, cells=6, ki=2, kf=0, sel_p=0.0),
    "negative_values": dict(n=3000, cells=12, ki=3, kf=0, lo=-10**15,
                            hi=0),
    "wraparound": dict(n=4100, cells=4, ki=2, kf=0, lo=BIG, hi=BIG + 9),
    "many_cells": dict(n=2048, cells=300, ki=1, kf=0),
    "one_cell": dict(n=5000, cells=6, ki=7, kf=0, hot=2),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_agg_plain_matches_pallas(case):
    rng = np.random.default_rng(len(case))
    gid, ivals, fvals, sel = _dense_case(rng, **DENSE_CASES[case])
    cells = DENSE_CASES[case]["cells"]
    counts, isums, _ = CK.dense_agg(T(gid), T(ivals), T(fvals), T(sel),
                                    cells)
    jc, ji, _ = jax_dense(gid, ivals, fvals, sel, cells)
    np.testing.assert_array_equal(counts.numpy(), jc)
    np.testing.assert_array_equal(isums.numpy(), ji)


def test_dense_agg_float_sums():
    rng = np.random.default_rng(3)
    gid, ivals, fvals, sel = _dense_case(rng, 3000, 25, 1, 2)
    counts, isums, fsums = CK.dense_agg(T(gid), T(ivals), T(fvals), T(sel),
                                        25)
    jc, ji, jf = jax_dense(gid, ivals, fvals, sel, 25)
    np.testing.assert_array_equal(counts.numpy(), jc)
    np.testing.assert_array_equal(isums.numpy(), ji)
    # the reference rounds each float to f32 before summing
    np.testing.assert_allclose(fsums.numpy(), jf, rtol=1e-6, atol=1e-3)


# ------------------------------------------------------------ probe_join

def _probe_case(rng, b, n, p, dup=False, sel_p=0.9, key_span=None):
    span = key_span or 4 * b
    bk = rng.permutation(span)[:b].astype(np.uint32)
    if dup:
        bk[1] = bk[0]
    bsel = rng.random(b) < 0.9
    if dup:
        bsel[:2] = True
    pk = rng.integers(0, span, n).astype(np.uint32)
    if dup:
        pk[:5] = bk[0]
    psel = rng.random(n) < sel_p
    if dup:
        psel[:5] = True
    pay = rng.integers(-BIG, BIG, (p, b), dtype=np.int64)
    return bk, bsel, pk, psel, pay


PROBE_CASES = {
    "q5_region": dict(b=5, n=3000, p=1),
    "q5_nation": dict(b=25, n=2500, p=2),
    "build_2048": dict(b=2048, n=1500, p=1),
    "ragged_n": dict(b=40, n=1025, p=3),
    "empty_selection": dict(b=25, n=2000, p=1, sel_p=0.0),
    "membership_only": dict(b=25, n=2000, p=0),
    "duplicate_key": dict(b=25, n=2000, p=2, dup=True),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_join_plain_matches_pallas(case):
    rng = np.random.default_rng(len(case) + 100)
    bk, bsel, pk, psel, pay = _probe_case(rng, **PROBE_CASES[case])
    # the port compares packed u32 keys as int32 storage
    matched, out, has_dup = CK.probe_join(
        T(bk.view(np.int32)), T(bsel), T(pk.view(np.int32)), T(psel),
        T(pay))
    jm, jo, jdup, match_f = jax_probe(bk, bsel, pk, psel, pay)
    np.testing.assert_array_equal(matched.numpy(), jm)
    assert bool(has_dup) == jdup == PROBE_CASES[case].get("dup", False)
    # a duplicate hit's payload is unspecified (the reference sums the
    # matching rows' limbs): compare single-match rows only
    single = match_f == 1.0
    np.testing.assert_array_equal(out.numpy()[:, single], jo[:, single])
    np.testing.assert_array_equal(out.numpy()[:, ~jm], 0)


# ------------------------------------------------------------ sorted_seg

# one input shape (N = 2049: a ragged tile count) keeps the interpret-mode
# reference to one compile; the cases differ in groups, selection, values
SEG_N = 2049
SEG_CASES = {
    "q3_shape": dict(groups=700),
    "empty_selection": dict(groups=40, sel_p=0.0),
    "wraparound": dict(groups=30, lo=BIG, hi=BIG + 9),
    "negative_values": dict(groups=300, lo=-10**15, hi=0),
    "one_group": dict(groups=1),
    # Q3's shape: the capacity is the input's row count, far above the
    # group count, so most output slots are padding
    "cap_much_larger": dict(groups=40, cap=SEG_N),
    # one key holds most rows beside many small groups
    "skewed": dict(groups=300, hot=0.9),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_sorted_segment_plain_matches_pallas(case):
    cfg = dict(sel_p=0.85, lo=-10**9, hi=10**9)
    cfg.update(SEG_CASES[case])
    rng = np.random.default_rng(len(case) + 7)
    n = SEG_N
    k1 = rng.integers(0, cfg["groups"], n).astype(np.int64)
    if "hot" in cfg:
        k1[rng.random(n) < cfg["hot"]] = 0
    k2 = (k1 % 3).astype(np.int32)
    sel = rng.random(n) < cfg["sel_p"]
    vals = {"s0": rng.integers(cfg["lo"], cfg["hi"], n, dtype=np.int64)}
    vals["a0"] = rng.integers(-10**6, 10**6, n).astype(np.int32)
    specs_j = [JK.AggSpec("sum", nm) for nm in vals if nm[0] == "s"] + \
        [JK.AggSpec("avg", "a0"), JK.AggSpec("count", "c")]
    specs_t = [TK.AggSpec(s.func, s.out_name) for s in specs_j]
    cap = cfg.get("cap", cfg["groups"] + 5)
    jk, ja, jsel, jn = PK.sorted_segment_aggregate(
        {"k1": jnp.asarray(k1), "k2": jnp.asarray(k2)},
        {k: jnp.asarray(v) for k, v in vals.items()}, specs_j,
        jnp.asarray(sel), cap, interpret=True)
    tv = {k: T(v) for k, v in vals.items()}
    assert CK.sorted_segment_eligible(specs_t, tv, n)
    tk, ta, tsel, tn = CK.sorted_segment_aggregate(
        {"k1": T(k1), "k2": T(k2)}, tv, specs_t, T(sel), cap)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    for k in jk:
        np.testing.assert_array_equal(tk[k].numpy(), np.asarray(jk[k]))
    for k in ja:
        assert ta[k].numpy().dtype == np.asarray(ja[k]).dtype, k
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]))


def test_dense_agg_plan():
    """The host's choice of the dense kernel's mode, block and shared
    memory: Q1 and Q5 take per-thread private accumulators, a wide domain
    the block-shared copy, Q1's keys at 4096 cells global atomics."""
    assert CK.dense_agg_plan(7, 0, 6) == ("private4", 256, 256 * 48 * 8)
    assert CK.dense_agg_plan(1, 0, 25) == ("private16", 256, 256 * 50 * 8)
    assert CK.dense_agg_plan(1, 2, 25) == ("private4", 256, 256 * 100 * 8)
    assert CK.dense_agg_plan(1, 0, 300) == ("shared", 256, 600 * 8)
    assert CK.dense_agg_plan(7, 0, 4096) == ("global", 256, 0)
    order = {"private4": 0, "private16": 0, "shared": 1, "global": 2}
    for ki, kf in ((0, 0), (1, 0), (0, 2), (7, 0), (3, 5), (12, 1)):
        last = 0
        for cells in (1, 2, 6, 25, 100, 300, 1000, 4096, 20000):
            mode, threads, smem = CK.dense_agg_plan(ki, kf, cells)
            slots = (1 + ki + kf) * cells
            assert order[mode] >= last  # a wider domain never goes back
            last = order[mode]
            assert smem <= CK.SMEM_MAX and threads % 32 == 0
            if mode.startswith("private"):
                assert threads >= 64 and smem == threads * slots * 8
                assert (mode == "private16") == (ki + kf <= 2)
            elif mode == "shared":
                assert smem == slots * 8
                assert 64 * slots * 8 > CK.SMEM_MAX
            else:
                assert smem == 0 and slots * 8 > CK.SMEM_MAX


@pytest.mark.parametrize("n,cap", [(0, 1), (1, 1), (32, 64), (33, 64),
                                   (2049, 2049), (5_997_925, 5_997_925),
                                   (5_997_925, 20)])
def test_sorted_seg_plan(n, cap):
    """The queue holds every group longer than short_rows that disjoint
    row ranges can hold: n // (short_rows + 1) of them, at most cap."""
    short_rows, chunk_rows, queue_cap, blocks = CK.sorted_seg_plan(n, cap)
    assert short_rows == CK.SEG_SHORT_ROWS and chunk_rows >= 32
    assert blocks >= 1
    assert queue_cap >= min(cap, n // (short_rows + 1))
    assert queue_cap <= cap + 1
    # the queue's entry count and first-chunk index share one word
    assert cap < CK.SEG_MAX_CAP and n // chunk_rows + cap < 1 << 36


def test_sorted_seg_header_sets_alternate():
    """Calls on one device and stream use the two header sets in turn, and
    each is handed the other to zero for the next call."""
    CK._SEG_HEADERS.pop((None, 12345), None)
    dev = torch.device("cpu")
    first, spare = CK._seg_headers(dev, 12345)
    second, spare2 = CK._seg_headers(dev, 12345)
    third, _ = CK._seg_headers(dev, 12345)
    assert first.data_ptr() == spare2.data_ptr() == third.data_ptr()
    assert second.data_ptr() == spare.data_ptr() != first.data_ptr()
    assert first.shape == (2,) and not first.any()
    CK._SEG_HEADERS.pop((None, 12345))


def test_sorted_segment_gate_matches_reference():
    n = 100
    ints = {"x": T(np.zeros(n, np.int64)), "f": T(np.zeros(n))}
    jints = {"x": jnp.zeros(n, jnp.int64), "f": jnp.zeros(n)}
    for specs in ([("sum", "x"), ("count", "c")], [("min", "x")],
                  [("sum", "f")], [("avg", "x")]):
        t = [TK.AggSpec(*s) for s in specs]
        j = [JK.AggSpec(*s) for s in specs]
        for rows in (n, PK.MAX_SEG_ROWS + 1):
            assert CK.sorted_segment_eligible(t, ints, rows) == \
                PK.sorted_segment_eligible(j, jints, rows)


def test_wrapper_refuses_other_devices():
    """A wrapper runs the plain version for CPU tensors only; anything
    else must launch the kernel or raise (here: the meta device)."""
    gid = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        CK.dense_agg(gid, torch.zeros((0, 8), dtype=torch.int64,
                                      device="meta"),
                     torch.zeros((0, 8), dtype=torch.float64, device="meta"),
                     torch.zeros(8, dtype=torch.bool, device="meta"), 4)
    with pytest.raises(TypeError):
        CK.dense_agg(torch.zeros(8, dtype=torch.int64),
                     torch.zeros((0, 8), dtype=torch.int64),
                     torch.zeros((0, 8), dtype=torch.float64),
                     torch.zeros(8, dtype=torch.bool), 4)
    with pytest.raises(ValueError):  # value rows shorter than gid
        CK.dense_agg(torch.zeros(8, dtype=torch.int32),
                     torch.zeros((2, 7), dtype=torch.int64),
                     torch.zeros((0, 8), dtype=torch.float64),
                     torch.zeros(8, dtype=torch.bool), 4)
    with pytest.raises(ValueError):  # fewer boundaries than slots
        CK.sorted_seg(torch.zeros((1, 8), dtype=torch.int64),
                      torch.zeros(3, dtype=torch.int64),
                      torch.zeros(3, dtype=torch.int64),
                      torch.tensor(2), 4)
    with pytest.raises(ValueError):
        CK.probe_join(torch.zeros(2049, dtype=torch.int32),
                      torch.zeros(2049, dtype=torch.bool),
                      torch.zeros(4, dtype=torch.int32),
                      torch.zeros(4, dtype=torch.bool),
                      torch.zeros((0, 2049), dtype=torch.int64))


def test_jax_runs_on_cpu():
    assert jax.default_backend() == "cpu"
