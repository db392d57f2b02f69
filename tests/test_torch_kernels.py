"""The port's kernel plain versions against the JAX Pallas kernels.

Each Pallas kernel runs as the JAX package's own tests run it on the CPU
(``interpret=True``), with the executor's limb split and recombination
reproduced as its call sites do (executor.py ``_dense_agg_pallas`` and
``_probe_join_pallas``, the latter with the key packing of the reference's
kernels.py; ``sorted_segment_aggregate`` directly). The port's
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
    """executor.py _probe_join_pallas: the key packing of the reference's
    kernels.py (key_ranges over the selected build rows, pack_with_ranges,
    downcast32), the Pallas kernel on u32 keys, 21/21/22-bit limbs."""
    bk = [jnp.asarray(k) for k in bkeys]
    ranges = JK.key_ranges(bk, jnp.asarray(bsel))
    bp = JK.downcast32(JK.pack_with_ranges(bk, ranges))
    pp = JK.downcast32(JK.pack_with_ranges([jnp.asarray(k) for k in pkeys],
                                           ranges))
    b, n = len(bsel), len(psel)
    rows = []
    for v in payload:
        rows.extend(PK.int64_to_limbs(jnp.asarray(v)))
    if not rows:
        rows = [jnp.zeros((b,), jnp.float32)]
    match_f, gathered = PK.probe_join_pallas(
        _pad(bp, 256), _pad(jnp.asarray(bsel), 256),
        _pad(pp, 1024), _pad(jnp.asarray(psel), 1024),
        _pad(jnp.stack(rows), 256), tile=1024, interpret=True)
    out = [np.asarray(PK.limbs_to_int64(gathered[3 * i, :n],
                                        gathered[3 * i + 1, :n],
                                        gathered[3 * i + 2, :n])
                      .astype(jnp.asarray(v).dtype))
           for i, v in enumerate(payload)]
    return (np.asarray(match_f[:n] > 0.5), out,
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

def _probe_keys(rng, kind, b, n):
    """Unique build keys ([B] per column) and probe keys ([N]) of a kind;
    probe keys are drawn from about four times the build's key range."""
    span = 4 * b
    ids = rng.permutation(span)[:b]
    pids = rng.integers(0, span, n)
    if kind == "int64":
        return [ids.astype(np.int64)], [pids.astype(np.int64)]
    if kind == "int32":
        return [ids.astype(np.int32)], [pids.astype(np.int32)]
    if kind == "two_column":  # (id // 7 int64, id % 7 int32)
        return ([(ids // 7).astype(np.int64), (ids % 7).astype(np.int32)],
                [(pids // 7).astype(np.int64), (pids % 7).astype(np.int32)])
    if kind == "out_of_range":  # probes below and above the build's range
        pk = rng.integers(-span, 2 * span, n)
        pk[:4] = [-1, ids.min() - 1, ids.max() + 1, 10 * span]
        return [ids.astype(np.int64)], [pk.astype(np.int64)]
    if kind == "negative_int64":
        scale = -(10 ** 12) - 7919
        return ([(ids * scale).astype(np.int64)],
                [(pids * scale).astype(np.int64)])
    if kind == "bool":
        return [np.array([True, False])[:b]], [rng.random(n) < 0.5]
    if kind == "float64":  # packed by sort_key_u64 in the wrapper;
        # neighbouring doubles, so the bit patterns' span fits 32 bits
        return [1.0 + ids * 2.0 ** -52], [1.0 + pids * 2.0 ** -52]
    if kind == "span_2_32":
        # two int32 columns of span 2^16 each: the product of spans is
        # exactly 2^32, so the build row (65535, 65535) packs to 2^32 - 1,
        # which the u32 narrowing makes the sentinel of an out-of-range
        # probe key (the executor's gate keeps such keys off this path)
        k1 = rng.integers(0, 1 << 16, b)
        k2 = rng.integers(0, 1 << 16, b)
        k1[:2], k2[:2] = [0, 65535], [0, 65535]
        _, first = np.unique(k1 * 65536 + k2, return_index=True)
        k1 = np.where(np.isin(np.arange(b), first), k1, 1)
        k2 = np.where(np.isin(np.arange(b), first), k2,
                      np.arange(b) + 2)
        p1 = rng.integers(-5, 1 << 16 + 1, n)
        p2 = rng.integers(-5, 1 << 16 + 1, n)
        p1[:b], p2[:b] = k1, k2
        return ([k1.astype(np.int32), k2.astype(np.int32)],
                [p1.astype(np.int32), p2.astype(np.int32)])
    raise KeyError(kind)


def _probe_case(rng, b, n, p=1, key="int64", dup=False, sel_p=0.9,
                bsel_p=0.9, pay=None):
    bk, pk = _probe_keys(rng, key, b, n)
    bsel = rng.random(b) < bsel_p
    psel = rng.random(n) < sel_p
    if dup:
        for col in bk:
            col[1] = col[0]
        bsel[:2] = True
        for pc, bc in zip(pk, bk):
            pc[:5] = bc[0]
        psel[:5] = True
    dtypes = pay or [np.int64] * p
    payload = []
    for dt in dtypes:
        if dt == np.bool_:
            payload.append(rng.random(b) < 0.5)
        elif dt == np.int32:
            payload.append(rng.integers(-2 ** 31, 2 ** 31, b)
                           .astype(np.int32))
        else:
            payload.append(rng.integers(-BIG, BIG, b, dtype=np.int64))
    return bk, bsel, pk, psel, payload


PROBE_CASES = {
    "q5_region": dict(b=5, n=3000, p=1),
    "q5_nation": dict(b=25, n=2500, p=2),
    "build_2048": dict(b=2048, n=1500, p=1),
    "ragged_n": dict(b=40, n=1025, p=3),
    "empty_selection": dict(b=25, n=2000, p=1, sel_p=0.0),
    "membership_only": dict(b=25, n=2000, p=0),
    "duplicate_key": dict(b=25, n=2000, p=2, dup=True),
    "two_column_key": dict(b=300, n=2000, p=1, key="two_column"),
    "two_column_duplicate": dict(b=60, n=1500, p=1, key="two_column",
                                 dup=True),
    "out_of_range_probe": dict(b=100, n=2000, p=1, key="out_of_range"),
    "negative_int64_key": dict(b=200, n=2000, p=1, key="negative_int64"),
    "int32_key": dict(b=700, n=2000, p=1, key="int32"),
    "bool_key": dict(b=2, n=2000, p=1, key="bool", bsel_p=1.0),
    "float64_key": dict(b=50, n=2000, p=1, key="float64"),
    "mixed_payload": dict(b=25, n=2000,
                          pay=[np.int32, np.int64, np.bool_]),
    "empty_build_selection": dict(b=25, n=2000, p=2, bsel_p=0.0),
    "span_2_32": dict(b=64, n=3000, p=1, key="span_2_32", bsel_p=1.0),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_join_plain_matches_pallas(case):
    """The port's fused operator, from the raw key columns, against the
    reference's packing + probe_join_pallas: the match mask, the duplicate
    flag, and the payload of single-match rows must be exact."""
    cfg = PROBE_CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    bk, bsel, pk, psel, pay = _probe_case(rng, **cfg)
    dup = torch.zeros(1, dtype=torch.int32)
    matched, out = CK.probe_join([T(k) for k in bk], T(bsel),
                                 [T(k) for k in pk], T(psel),
                                 [T(c) for c in pay], dup)
    jm, jo, jdup, match_f = jax_probe(bk, bsel, pk, psel, pay)
    assert matched.dtype == torch.bool
    np.testing.assert_array_equal(matched.numpy(), jm)
    assert int(dup[0]) == int(jdup) == int(cfg.get("dup", False))
    # a duplicate hit's payload is unspecified (the reference sums the
    # matching rows' limbs): compare single-match rows only
    single = match_f == 1.0
    assert len(out) == len(jo)
    for got, want in zip(out, jo):
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy()[single], want[single])
        np.testing.assert_array_equal(got.numpy()[~jm], 0)
    if case == "span_2_32":  # out-of-range probes hit the (65535, 65535) row
        oob = ((pk[0] < 0) | (pk[0] > 65535) | (pk[1] < 0) | (pk[1] > 65535))
        assert (jm & oob & psel).any()
    if case == "empty_selection" or case == "empty_build_selection":
        assert not jm.any()


def test_probe_join_flag_is_sticky():
    """dup is the caller's slot: a join without duplicates leaves a set
    flag set, and a second duplicate hit keeps it at 1."""
    rng = np.random.default_rng(9)
    bk, bsel, pk, psel, pay = _probe_case(rng, 25, 500, 1)
    dup = torch.ones(1, dtype=torch.int32)
    CK.probe_join([T(k) for k in bk], T(bsel), [T(k) for k in pk], T(psel),
                  [T(c) for c in pay], dup)
    assert int(dup[0]) == 1
    bk, bsel, pk, psel, pay = _probe_case(rng, 25, 500, 1, dup=True)
    CK.probe_join([T(k) for k in bk], T(bsel), [T(k) for k in pk], T(psel),
                  [T(c) for c in pay], dup)
    assert int(dup[0]) == 1


def test_probe_join_argument_block_matches_source():
    """The wrapper's argument block has the layout of probe_join.cu's
    ProbeJoinArgs, and its column limits are the kernel's."""
    src = (CK.CSRC / "probe_join.cu").read_text()
    assert f"constexpr int kMaxKeys = {CK.PROBE_MAX_KEYS};" in src
    assert f"constexpr int kMaxPayload = {CK.PROBE_MAX_PAYLOAD};" in src
    assert f"constexpr int kMaxBuild = {CK.PROBE_MAX_BUILD};" in src
    assert f"sizeof(ProbeJoinArgs) == {CK._PROBE_ARGS.size}" in src
    assert CK._PROBE_ARGS.size == 400


_BOOL8, _I32_8 = torch.zeros(8, dtype=torch.bool), \
    torch.zeros(8, dtype=torch.int32)
PROBE_REFUSALS = {
    "build_above_2048": lambda: ([torch.zeros(2049, dtype=torch.int32)],
                                 torch.zeros(2049, dtype=torch.bool),
                                 [_I32_8], _BOOL8, []),
    "five_key_columns": lambda: ([_I32_8] * 5, _BOOL8, [_I32_8] * 5,
                                 _BOOL8, []),
    "key_counts_differ": lambda: ([_I32_8] * 2, _BOOL8, [_I32_8], _BOOL8,
                                 []),
    "no_key_column": lambda: ([], _BOOL8, [], _BOOL8, []),
    "seventeen_payload_columns": lambda: ([_I32_8], _BOOL8, [_I32_8],
                                          _BOOL8, [_I32_8] * 17),
    "short_probe_key": lambda: ([_I32_8], _BOOL8,
                                [torch.zeros(7, dtype=torch.int32)],
                                _BOOL8, []),
}


@pytest.mark.parametrize("case", sorted(PROBE_REFUSALS))
def test_probe_join_refuses_what_the_kernel_cannot_take(case):
    with pytest.raises(ValueError):
        CK.probe_join(*PROBE_REFUSALS[case](),
                      torch.zeros(1, dtype=torch.int32))


def test_probe_join_refuses_float_payload_and_bad_flag():
    with pytest.raises(TypeError):
        CK.probe_join([_I32_8], _BOOL8, [_I32_8], _BOOL8,
                      [torch.zeros(8, dtype=torch.float64)],
                      torch.zeros(1, dtype=torch.int32))
    with pytest.raises(TypeError):
        CK.probe_join([_I32_8], _BOOL8, [_I32_8], _BOOL8, [],
                      torch.zeros(1, dtype=torch.bool))


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
        CK.probe_join([torch.zeros(4, dtype=torch.int32, device="meta")],
                      torch.zeros(4, dtype=torch.bool, device="meta"),
                      [torch.zeros(8, dtype=torch.int32, device="meta")],
                      torch.zeros(8, dtype=torch.bool, device="meta"), [],
                      torch.zeros(1, dtype=torch.int32, device="meta"))


def test_jax_runs_on_cpu():
    assert jax.default_backend() == "cpu"
