"""The distributed executor's device helpers against the JAX package, on the
CPU: the hashing device half (routing must equal host placement bit for
bit, or rows land on the wrong segment), the packed wire, the bloom
digest, the wire re-bucket, the capacity ladder and the one-card
collectives. Exact equality throughout: every value here is integer bits.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloudberry_tpu.exec import kernels as JK
from cloudberry_tpu.utils import hashing as JH
from cloudberry_tpu_torch.exec import kernels as TK
from cloudberry_tpu_torch.parallel import mesh as TM
from cloudberry_tpu_torch.parallel import transport as TT
from cloudberry_tpu_torch.utils import hashing as TH

ROOT = Path(__file__).resolve().parent.parent


def _keys(dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.integers(0, 2, 500).astype(np.bool_)
    if dtype in (np.float64, np.float32):
        edge = [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e300, -1e-300,
                5e-324, 1.0]
        with np.errstate(over="ignore"):   # 1e300 is inf as float32
            return np.concatenate([rng.normal(size=490) * 1e6,
                                   edge]).astype(dtype)
    info = np.iinfo(dtype)
    edge = [0, -1, 1, info.min, info.max, info.min + 1, info.max - 1, 2, 3,
            -2]
    return np.concatenate([rng.integers(info.min, info.max, 490,
                                        dtype=dtype), edge]).astype(dtype)


DTYPES = [np.int64, np.int32, np.float64, np.float32, np.bool_]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_device_routing_equals_host_placement(dtype):
    """hash_columns + jump_consistent_hash on the device equal JAX's jnp
    half and the numpy host half, for nseg 1..16, one and two key columns
    (-0.0 and NaN hash by bit pattern)."""
    a, b = _keys(dtype, 1), _keys(np.int64, 2)
    for cols in ([a], [a, b]):
        hn = JH.hash_columns_np(cols)
        hj = np.asarray(JH.hash_columns_jnp([jnp.asarray(c) for c in cols]))
        ht = TH.hash_columns([torch.from_numpy(c) for c in cols]).numpy()
        np.testing.assert_array_equal(ht, hn.view(np.int64))
        np.testing.assert_array_equal(ht, hj.view(np.int64))
        for nseg in range(1, 17):
            want = JH.jump_consistent_hash_np(hn, nseg)
            got = TH.jump_consistent_hash(torch.from_numpy(ht), nseg)
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(
                got.numpy(),
                np.asarray(JH.jump_consistent_hash_jnp(jnp.asarray(hn),
                                                       nseg)))


def _wire_cols(n, n_bools, seed=3):
    rng = np.random.default_rng(seed)
    cols = {"i64": _keys(np.int64, seed)[:n],
            "f64": _keys(np.float64, seed)[:n],
            "i32": _keys(np.int32, seed)[:n],
            "f32": _keys(np.float32, seed)[:n]}
    for i in range(n_bools):
        cols[f"b{i:02d}"] = rng.integers(0, 2, n).astype(np.bool_)
    sel = rng.integers(0, 2, n).astype(np.bool_)
    return cols, sel


@pytest.mark.parametrize("n_bools", [0, 3, 31, 40])
def test_pack_wire_words_equal_jax_and_round_trip(n_bools):
    """The packed wire's words equal JAX's uint32 words bit for bit
    (int32 here), past 31 bools too (a second flag word), and unpack to
    bit-identical columns and the validity mask."""
    cols, sel = _wire_cols(200, n_bools)
    jl = JK.wire_layout({k: v.dtype for k, v in cols.items()})
    tl = TK.wire_layout({k: torch.from_numpy(v).dtype
                         for k, v in cols.items()})
    assert (jl.width, jl.offsets, jl.flag_bits, jl.n_flag_words) == \
        (tl.width, tl.offsets, tl.flag_bits, tl.n_flag_words)
    assert jl.payload_bytes() == tl.payload_bytes()
    jb = np.asarray(JK.pack_wire({k: jnp.asarray(v) for k, v in cols.items()},
                                 jnp.asarray(sel), jl))
    tb = TK.pack_wire({k: torch.from_numpy(v) for k, v in cols.items()},
                      torch.from_numpy(sel), tl)
    np.testing.assert_array_equal(tb.numpy(), jb.view(np.int32))
    back, bsel = TK.unpack_wire(tb, tl)
    np.testing.assert_array_equal(bsel.numpy(), sel)
    for k, v in cols.items():
        assert back[k].dtype == torch.from_numpy(v).dtype
        np.testing.assert_array_equal(back[k].numpy().view(np.uint8),
                                      v.view(np.uint8))


def test_wire_layout_refuses_odd_widths():
    with pytest.raises(NotImplementedError):
        TK.wire_layout({"x": torch.int16})


@pytest.mark.parametrize("nkeys", [1, 2])
def test_bloom_build_and_test_equal_jax(nkeys):
    rng = np.random.default_rng(5)
    build = [rng.integers(-1000, 1000, 300) for _ in range(nkeys)]
    probe = [rng.integers(-2000, 2000, 700) for _ in range(nkeys)]
    bsel = rng.integers(0, 2, 300).astype(np.bool_)
    for bits in (64, 1 << 12, JK.bloom_bits_pow2(1000)):
        assert TK.bloom_bits_pow2(bits) == JK.bloom_bits_pow2(bits)
        bits = JK.bloom_bits_pow2(bits)
        ju = [JK.sort_key_u64(jnp.asarray(k)) for k in build]
        tu = [TK.sort_key_u64(torch.from_numpy(k)) ^ TK._I64_MIN
              for k in build]
        jw = np.asarray(JK.bloom_build(ju, jnp.asarray(bsel), bits, 3))
        tw = TK.bloom_build(tu, torch.from_numpy(bsel), bits, 3)
        np.testing.assert_array_equal(tw.numpy(), jw.view(np.int32))
        jt = JK.bloom_test(jnp.asarray(jw),
                           [JK.sort_key_u64(jnp.asarray(k)) for k in probe],
                           bits, 3)
        tt = TK.bloom_test(tw, [TK.sort_key_u64(torch.from_numpy(k))
                                ^ TK._I64_MIN for k in probe], bits, 3)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("cap", [4, 64])
def test_wire_rebucket_equals_jax(cap):
    """Stable compaction into bucket slots, rows past ``cap`` dropped but
    counted — the redistribute's slot discipline."""
    cols, sel = _wire_cols(300, 5, seed=9)
    layout = JK.wire_layout({k: v.dtype for k, v in cols.items()})
    rows = np.asarray(JK.pack_wire(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(sel),
        layout))
    key = np.random.default_rng(2).integers(0, 8, 300).astype(np.int32)
    jr, jc = JK.wire_rebucket(jnp.asarray(rows), jnp.asarray(key),
                              jnp.asarray(sel), 8, cap)
    tr, tc = TK.wire_rebucket(torch.from_numpy(rows.view(np.int32).copy()),
                              torch.from_numpy(key), torch.from_numpy(sel),
                              8, cap)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr).view(np.int32))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_rung_up_ladder():
    for n in [-5, 0, 1, 7, 8, 9, 63, 64, 65, 1000, 1 << 20, (1 << 20) + 1]:
        assert TK.rung_up(n) == JK.rung_up(n)
        r = TK.rung_up(n)
        assert r >= max(n, 8) and r & (r - 1) == 0


def test_one_card_collectives_equal_the_mesh_collectives():
    """all_to_all is the (src, dst) transpose of the segments' blocks and
    all_gather their concatenation in segment order — the same buffers as
    the JAX package's collectives over its 8-device mesh."""
    from jax.sharding import Mesh, PartitionSpec as P

    from cloudberry_tpu.exec.dist_executor import _shard_map

    nseg, B, W = 8, 3, 2
    x = np.arange(nseg * nseg * B * W, dtype=np.int32).reshape(
        nseg, nseg, B, W)
    mesh = Mesh(np.asarray(jax.devices()[:nseg]), ("seg",))

    def f(blk):
        return (jax.lax.all_to_all(blk[0], "seg", 0, 0, tiled=False)[None],
                jax.lax.all_gather(blk[0, 0], "seg", axis=0, tiled=True)[None])

    a2a, ag = jax.jit(_shard_map(f, mesh, (P("seg"),),
                                 (P("seg"), P("seg"))))(x)
    tx = TT.make_transport("xla", nseg)
    got = tx.all_to_all([torch.from_numpy(x[s]) for s in range(nseg)])
    for d in range(nseg):
        np.testing.assert_array_equal(got[d].numpy(), np.asarray(a2a)[d])
    gathered = tx.all_gather([torch.from_numpy(x[s, 0]) for s in range(nseg)])
    for d in range(nseg):
        np.testing.assert_array_equal(gathered.numpy(), np.asarray(ag)[d])
    parts = [torch.tensor(s) for s in range(nseg)]
    assert int(tx.psum(parts)) == sum(range(nseg))
    assert int(tx.pmax(parts)) == nseg - 1


def test_unported_transports_raise(monkeypatch):
    """Every transport the reference names is built (the test keeps the
    name it had while the ring and the forced split raised): "ring" with
    its chunks, the two-level one under CBTPU_FORCE_HOSTS, an unknown
    name still raises; the survivor restriction is still checked against
    the slot pool, outside the forced layout's path."""
    ring = TT.make_transport("ring", 8, chunks=4)
    assert isinstance(ring, TT.RingCollectives) and ring.chunks == 4
    with pytest.raises(ValueError):
        TT.make_transport("carrier-pigeon", 8)
    assert isinstance(TT.make_transport("xla", 8), TT.OneCardCollectives)
    monkeypatch.setenv("CBTPU_FORCE_HOSTS", "2")
    topo = TM.host_topology(8)
    assert topo.forced and topo.segs_by_host == ((0, 1, 2, 3),
                                                 (4, 5, 6, 7))
    tx = TT.make_transport("xla", 8, topo=topo)
    assert isinstance(tx, TT.HierarchicalCollectives) and tx.S == 4
    with pytest.raises(ValueError, match="CBTPU_FORCE_HOSTS"):
        TM.host_topology(6 + 1)
    with pytest.raises(TM.DeviceRestrictionError):
        TT.make_transport("xla", 8, device_ids=[8])
    monkeypatch.delenv("CBTPU_FORCE_HOSTS")
    topo = TM.host_topology(8)
    assert topo.n_hosts == 1 and topo.segs_by_host == (tuple(range(8)),)
    # a survivor restriction is checked against the slot pool (the
    # segment count by default), as the reference checks its devices
    with pytest.raises(TM.DeviceRestrictionError):
        TM.host_topology(8, device_ids=[8])
    with pytest.raises(RuntimeError, match="slots survive"):
        TT.make_transport("xla", 8, device_ids=[0, 1], n_slots=8)


def test_distributed_modules_import_no_jax():
    code = ("import sys\n"
            "import cloudberry_tpu_torch.exec.dist_executor\n"
            "import cloudberry_tpu_torch.parallel.mesh\n"
            "import cloudberry_tpu_torch.parallel.transport\n"
            "import cloudberry_tpu_torch.plan.memo\n"
            "import cloudberry_tpu_torch.plan.feedback\n"
            "import cloudberry_tpu_torch.plan.verify\n"
            "import cloudberry_tpu_torch.plan.distribute\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": str(ROOT)})
    mods = out.stdout.split()
    assert "cloudberry_tpu_torch.exec.dist_executor" in mods
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")
                or m == "cloudberry_tpu" or m.startswith("cloudberry_tpu.")]
