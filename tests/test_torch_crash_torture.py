"""The process-kill torture harness of the port
(``cloudberry_tpu_torch/tools/crash_torture.py``) on the CPU — the cases
of ``tests/test_crash_torture.py``.

A port server subprocess (``python -m cloudberry_tpu_torch --device cpu
... serve``) is killed at an armed durability seam (``os._exit(137)``
mid-write), restarted clean, and the acked/unacked ledger is verified
over the wire, then offline by the port's fsck. The store the kill left
is shared with the JAX package's format, so the JAX package's fsck must
give the same report over it. The full matrix is slow-tier, as in the
reference; tier 1 keeps one end-to-end smoke."""

import os
import shutil

import pytest

from cloudberry_tpu_torch.tools import crash_torture as ct


def _assert_clean(rec):
    assert rec["problems"] == [], (
        f"{rec['seam']}@{rec['hit']}: {rec['problems']}")
    assert rec["fired"], f"{rec['seam']} never fired"
    assert rec["exit_code"] == 137
    assert rec["acked_lost"] == 0
    assert rec["fsck_clean"] is True
    assert rec["recovery_ms"] is not None


def test_single_seam_smoke(tmp_path):
    """Kill INSIDE the manifest commit (after the new v{N}.json is
    written, before CURRENT swings): zero acked loss, fsck clean,
    orphans collected; the JAX package's fsck reads the surviving store
    as the port's does. (One GC pass collects the manifest written ahead
    of CURRENT; the partition only it referenced becomes an orphan for
    the next pass, in both engines.)"""
    from cloudberry_tpu.storage.fsck import fsck as jfsck
    from cloudberry_tpu_torch.storage.fsck import fsck as tfsck

    store = str(tmp_path / "store")
    rec = ct.run_seam("storage_commit_before_current", hit=14,
                      store=store, device="cpu")
    _assert_clean(rec)
    assert rec["acked_inserts"] > 0  # the kill came after real acks
    want, got = jfsck(store, deep=True), tfsck(store, deep=True)
    assert got == want and got["clean"]
    assert set(got["tables"]) == {"tort", "ing"}
    # the second GC pass, each engine on its own copy of the store
    reps = []
    for fn, name in ((jfsck, "jax"), (tfsck, "port")):
        copy = str(tmp_path / name)
        shutil.copytree(store, copy)
        rep = fn(copy, grace_s=0.0, gc=True)
        reps.append({k: v for k, v in rep.items() if k != "root"})
    assert reps[1] == reps[0] and reps[1]["orphans"] == []


def test_matrix_matches_the_reference():
    """The port tortures the reference's seams at the reference's hit
    counts — at least ten distinct durability seams — and each is a seam
    of the port's fault inventory."""
    from cloudberry_tpu_torch.utils import faultinject as FI
    from tools import crash_torture as jct

    assert ct.MATRIX_SEAMS == jct.MATRIX_SEAMS
    assert ct._SERVE_OVERRIDES == jct._SERVE_OVERRIDES
    assert len({s for s, _ in ct.MATRIX_SEAMS}) >= 10
    assert {s for s, _ in ct.MATRIX_SEAMS} <= set(FI.INVENTORY)


def test_server_child_runs_the_port(tmp_path, capsys):
    """The harness's server child is the port's CLI on the asked
    device, run from the checkout that holds the package."""
    from cloudberry_tpu_torch.mgmt import cli

    assert os.path.isdir(os.path.join(ct.REPO, "cloudberry_tpu_torch"))
    store = str(tmp_path / "s")
    assert cli.main(["--store", store, "init"]) == 0
    srv = ct.ServerProc(store, device="cpu")
    try:
        assert srv.banner
        assert srv.proc.args[:5] == [srv.proc.args[0], "-m",
                                     "cloudberry_tpu_torch", "--device",
                                     "cpu"]
        c = srv.client()
        assert c.sql("select 1 as x")["rows"] == [[1]]
        c.close()
    finally:
        srv.kill()


@pytest.mark.slow  # 11 server lifecycles: minutes of wall clock
@pytest.mark.parametrize("seam,hit", ct.MATRIX_SEAMS,
                         ids=[s for s, _ in ct.MATRIX_SEAMS])
def test_matrix_seam(seam, hit):
    """The full crash matrix, one seam per test so a regression names
    its seam: zero acked loss, bit-identical read set, fsck clean."""
    _assert_clean(ct.run_seam(seam, hit=hit, device="cpu"))
