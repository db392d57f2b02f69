"""The port's ring and two-level transports against the one-card exchange
and the JAX package's transports, on the CPU.

The ring (shift-composed) collectives must equal the one-card exchange on
every primitive, at a power-of-two and a non-power-of-two segment count,
whole-block and chunked. The two-level exchange (``hier_all_to_all``, the
tree ``all_gather``, ``host_ring_exchange``) must return what the JAX
package's ``HierarchicalCollectives`` returns through its ``_shard_map``
on the 8-device CPU mesh, for every segment, with the same ``launches``
count, at 2 and 4 simulated hosts (``CBTPU_FORCE_HOSTS``). Every
comparison is exact: the payloads are integer bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_parity  # noqa: F401  (one torch thread per worker)
from cloudberry_tpu.exec.dist_executor import _shard_map
from cloudberry_tpu.parallel import mesh as JM
from cloudberry_tpu.parallel import transport as JT
from cloudberry_tpu_torch.parallel import mesh as TM
from cloudberry_tpu_torch.parallel import transport as TT

NSEG = 8


def _blocks(nseg, B, W, seed, valid_frac=0.6):
    """(nseg, nseg, B, W) uint32 per-destination wire blocks with the wire
    convention: word 0 bit 0 is validity, invalid slots are all zero."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2 ** 32, (nseg, nseg, B, W), dtype=np.uint64) \
        .astype(np.uint32)
    valid = rng.random((nseg, nseg, B)) < valid_frac
    x[..., 0] = (x[..., 0] & ~np.uint32(1)) | valid.astype(np.uint32)
    return np.where(valid[..., None], x, 0).astype(np.uint32), valid


def _t(a):
    """A numpy uint32 array as the port's int32 words (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# ------------------------------------------------------------ the ring


@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("nseg", [8, 5])
@pytest.mark.parametrize("prim", ["all_gather", "psum", "pmax",
                                  "all_to_all"])
def test_ring_matches_one_card(prim, nseg, chunks):
    """Every ring primitive equals the one-card exchange bit for bit;
    the ring's gather is the same for every segment."""
    B, W = 12, 7
    x, _ = _blocks(nseg, B, W, seed=nseg * 10 + chunks)
    one, ring = TT.OneCardCollectives(), TT.make_transport(
        "ring", nseg, chunks=chunks)
    assert isinstance(ring, TT.RingCollectives) and ring.chunks == chunks
    if prim == "all_to_all":
        xs = [_t(x[s]) for s in range(nseg)]
        for a, b in zip(ring.all_to_all(xs), one.all_to_all(xs)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        return
    rows = [_t(x[s, 0]) for s in range(nseg)]
    if prim == "all_gather":
        each = ring.all_gather_each(rows)
        want = one.all_gather(rows).numpy()
        for s in range(nseg):
            np.testing.assert_array_equal(each[s].numpy(), want)
        np.testing.assert_array_equal(ring.all_gather(rows).numpy(), want)
        return
    vals = [r.to(torch.int64)[:, 1] for r in rows]
    np.testing.assert_array_equal(getattr(ring, prim)(vals).numpy(),
                                  getattr(one, prim)(vals).numpy())


@pytest.mark.parametrize("nseg,chunks", [(8, 4), (6, 1)])
def test_ring_all_to_all_equals_jax_ring(nseg, chunks):
    """The port's ring all_to_all on a packed buffer equals the JAX
    package's ppermute ring through its shard_map, per segment."""
    B, W = 12, 7
    x, _ = _blocks(nseg, B, W, seed=nseg + chunks)
    mesh = JM.segment_mesh(nseg)
    jtx = JT.make_transport("ring", nseg, chunks=chunks)
    f = jax.jit(_shard_map(
        lambda v: jtx.all_to_all(v[0], JM.SEG_AXIS)[None], mesh,
        (P(JM.SEG_AXIS),), P(JM.SEG_AXIS)))
    want = np.asarray(f(x)).view(np.int32)
    got = TT.make_transport("ring", nseg, chunks=chunks).all_to_all(
        [_t(x[s]) for s in range(nseg)])
    for d in range(nseg):
        np.testing.assert_array_equal(got[d].numpy(), want[d])


# ---------------------------------------------------- the two-level one


def _jax_hier(x, n_hosts, host_cap):
    """The JAX package's two-level exchange of ``x`` on the 8-device
    mesh: per segment (recv, host_demand, tree gather, ring exchange of
    row 0) and its trace-time launch count."""
    mesh = JM.segment_mesh(NSEG)
    topo = JM.host_topology(NSEG)
    assert topo.n_hosts == n_hosts
    tx = JT.HierarchicalCollectives(topo)
    B, W = x.shape[2], x.shape[3]

    def fn(v):
        a = v[0]
        recv, dem = tx.hier_all_to_all(a, JM.SEG_AXIS, host_cap=host_cap)
        gat = tx.all_gather(a.reshape(NSEG * B, W), JM.SEG_AXIS)
        ring = tx.host_ring_exchange(a[0, 0], JM.SEG_AXIS)
        return recv[None], dem[None], gat[None], ring[None]

    f = jax.jit(_shard_map(fn, mesh, (P(JM.SEG_AXIS),),
                           (P(JM.SEG_AXIS),) * 4))
    outs = [np.asarray(o) for o in f(x)]
    return outs, tx.launches


@pytest.mark.parametrize("small_cap", [False, True],
                         ids=["proven_cap", "overflow_cap"])
@pytest.mark.parametrize("n_hosts", [2, 4])
def test_hier_exchange_equals_jax(monkeypatch, n_hosts, small_cap):
    """hier_all_to_all's received buffers and host demand, the tree
    gather and the host ring exchange equal the JAX package's for every
    segment, with equal launches; at the proven host rung they also
    equal the one-card exchange. An undersized host rung drops the same
    rows in both engines and reports the same demand."""
    monkeypatch.setenv("CBTPU_FORCE_HOSTS", str(n_hosts))
    S, B, W = NSEG // n_hosts, 16, 5
    host_cap = 8 if small_cap else S * S * B
    x, valid = _blocks(NSEG, B, W, seed=3 + n_hosts)
    (jrecv, jdem, jgat, jring), jlaunch = _jax_hier(x, n_hosts, host_cap)

    topo = TM.host_topology(NSEG)
    assert topo.forced and topo.n_hosts == n_hosts
    assert topo.as_dict() == JM.host_topology(NSEG).as_dict()
    tx = TT.HierarchicalCollectives(topo)
    xs = [_t(x[s]) for s in range(NSEG)]
    recv, dem = tx.hier_all_to_all(xs, host_cap)
    gat = tx.tree_all_gather(torch.stack(xs).reshape(NSEG, NSEG * B, W))
    ring = tx.host_ring_exchange(torch.stack([a[0, 0] for a in xs]))
    assert tx.launches == jlaunch > 0
    flat = TT.OneCardCollectives().all_to_all(xs)
    for s in range(NSEG):
        np.testing.assert_array_equal(recv[s].numpy(),
                                      jrecv[s].view(np.int32))
        if not small_cap:
            np.testing.assert_array_equal(recv[s].numpy(),
                                          flat[s].numpy())
        np.testing.assert_array_equal(gat[s].numpy(),
                                      jgat[s].view(np.int32))
        np.testing.assert_array_equal(ring[s].numpy(),
                                      jring[s].view(np.int32))
    np.testing.assert_array_equal(
        dem.numpy(), jdem.reshape(NSEG, n_hosts))
    # every valid row is accounted to exactly one host pair
    assert int(dem.sum()) == int(valid.sum())
    # the interface's all_gather: the tree for unsigned payloads, the flat
    # gather (no permutation) otherwise — the same buffer either way
    rows = [a.reshape(NSEG * B, W) for a in xs]
    before = tx.launches
    np.testing.assert_array_equal(
        tx.all_gather(rows).numpy(),
        TT.OneCardCollectives().all_gather(rows).numpy())
    assert tx.launches == before
    np.testing.assert_array_equal(
        tx.all_gather(rows, unsigned=True).numpy(), gat[0].numpy())
    assert tx.launches == before + 2 * (S - 1) + (n_hosts - 1)


def test_intra_all_gather_equals_jax(monkeypatch):
    """The intra-host gather (the host combine's and the digest's first
    hop) equals the JAX package's per segment."""
    monkeypatch.setenv("CBTPU_FORCE_HOSTS", "2")
    rng = np.random.default_rng(9)
    x = rng.integers(0, 2 ** 31, (NSEG, 6, 3)).astype(np.uint32)
    tx = JT.HierarchicalCollectives(JM.host_topology(NSEG))
    f = jax.jit(_shard_map(
        lambda v: tx.intra_all_gather(v[0], JM.SEG_AXIS)[None],
        JM.segment_mesh(NSEG), (P(JM.SEG_AXIS),), P(JM.SEG_AXIS)))
    want = np.asarray(f(x)).view(np.int32)
    ttx = TT.HierarchicalCollectives(TM.host_topology(NSEG))
    np.testing.assert_array_equal(ttx.intra_all_gather(_t(x)).numpy(),
                                  want)
    assert ttx.launches == tx.launches == 3


@pytest.mark.parametrize("nseg,hosts,B,HB,rb",
                         [(8, 2, 64, 512, 24), (8, 4, 128, 256, 16),
                          (12, 3, 32, 64, 40)])
def test_wire_models_equal_jax(nseg, hosts, B, HB, rb):
    assert TT.two_level_lane_rows(nseg, hosts, B) == \
        JT.two_level_lane_rows(nseg, hosts, B)
    assert TT.two_level_wire_model(nseg, hosts, B, HB, rb) == \
        JT.two_level_wire_model(nseg, hosts, B, HB, rb)
    assert TT.flat_wire_model(nseg, hosts, B, rb) == \
        JT.flat_wire_model(nseg, hosts, B, rb)


# ------------------------------------------------ layout and the gate


@pytest.mark.parametrize("force", [None, "1", "2", "4", "8"])
def test_host_topology_equals_jax(monkeypatch, force):
    """The derived layout equals the JAX package's on one process, with
    and without a forced split; mesh_topology renders it."""
    if force is None:
        monkeypatch.delenv("CBTPU_FORCE_HOSTS", raising=False)
    else:
        monkeypatch.setenv("CBTPU_FORCE_HOSTS", force)
    got, want = TM.host_topology(NSEG), JM.host_topology(NSEG)
    assert got.as_dict() == want.as_dict()
    assert [got.host_of(s) for s in range(NSEG)] == \
        [want.host_of(s) for s in range(NSEG)]
    assert TM.mesh_topology(NSEG) == JM.mesh_topology(NSEG)


def test_forced_split_must_divide(monkeypatch):
    """A forced host count that does not divide the segments raises
    ValueError in both engines; the gate then stays flat instead."""
    import cloudberry_tpu as cb
    from cloudberry_tpu_torch import Config as TorchConfig

    monkeypatch.setenv("CBTPU_FORCE_HOSTS", "4")
    for mod in (TM, JM):
        with pytest.raises(ValueError, match="does not divide"):
            mod.host_topology(7)
    assert TT.hier_topology(TorchConfig(), 7) is None
    assert JT.hier_topology(cb.get_config(), 7) is None
    # a survivor restriction is not read under a forced split, as in the
    # reference; the transport's own check still holds the slot pool
    assert TM.host_topology(8, [0, 1, 2, 3, 4, 5, 6, 9]).n_hosts == 4
    with pytest.raises(TM.DeviceRestrictionError):
        TT.make_transport("xla", 8, device_ids=[0, 1, 2, 3, 4, 5, 6, 9])


@pytest.mark.parametrize("over,want", [
    ({}, 4), ({"interconnect.hierarchical": "on"}, 4),
    ({"interconnect.hierarchical": "off"}, None),
    ({"interconnect.backend": "ring"}, None),
    ({"interconnect.packed_wire": False}, None)])
def test_hier_gate_equals_jax(monkeypatch, over, want):
    import cloudberry_tpu as cb
    from cloudberry_tpu_torch import Config as TorchConfig

    monkeypatch.setenv("CBTPU_FORCE_HOSTS", "4")
    got = TT.hier_topology(TorchConfig().with_overrides(**over), NSEG)
    ref = JT.hier_topology(cb.get_config().with_overrides(**over), NSEG)
    assert (got and got.n_hosts) == (ref and ref.n_hosts) == want
    tx = TT.make_transport(TorchConfig().with_overrides(**over)
                           .interconnect.backend, NSEG, topo=got)
    assert isinstance(tx, TT.HierarchicalCollectives) == (want is not None)
    monkeypatch.delenv("CBTPU_FORCE_HOSTS")
    assert TT.hier_topology(TorchConfig().with_overrides(**over),
                            NSEG) is None
