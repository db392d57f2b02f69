"""Process-kill torture harness — crash-only storage, proven by killing.

The crash-recovery tests that matter run against a REAL server process
over the wire, not a mocked store: this harness launches
``python -m cloudberry_tpu_torch --device D ... serve`` with
``CBTPU_INJECT`` arming one
durability seam with the ``crash`` action (``os._exit(137)`` — the
in-process SIGKILL), drives a mixed workload (multi-row INSERTs, DELETEs
of previously-acked rows, sequence nextval, wire appends through the
ingest plane) while recording exactly which statements were
ACKNOWLEDGED, waits for the kill, restarts the server clean, and
verifies the crash-only contract:

- every acked write is durable and bit-identical (v == k * 7 for every
  row the workload wrote — a flipped bit or truncated blob cannot hide);
- unacked statements are all-or-nothing (both rows of the statement or
  neither — never a torn half-statement);
- acked DELETEs stay deleted; unacked DELETEs are all-or-nothing;
- an acked ``nextval`` value is never handed out again after restart;
- the port's ``fsck`` finds zero corruption (orphans — crash residue —
  are expected, collectable, and gone after ``--gc``);
- recovery_ms: restart-to-first-answered-query wall clock.

The server runs on ``device`` (default ``cuda``; ``cpu`` runs the
kernels' plain versions). Run one seam or the whole matrix:

    python -m cloudberry_tpu_torch.tools.crash_torture --seam io_manifest_write
    python -m cloudberry_tpu_torch.tools.crash_torture --matrix --json

Exit 0 iff every run verified clean.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

# the checkout holding the package: the server child runs from there
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the matrix: every durability seam the wire workload reaches, with a
# hit count late enough that setup DDL and a few acked writes precede
# the kill (the interesting state is acked-then-killed, not empty-store)
MATRIX_SEAMS = [
    ("io_partition_write", 14),
    ("io_manifest_write", 14),
    ("storage_commit_before_current", 14),
    ("storage_commit_after_current", 14),
    ("io_atomic_json", 6),
    ("io_feedback_write", 2),
    ("io_journal_write", 2),
    ("compact_chunk", 1),
    ("compact_commit", 1),
    ("ingest_flush", 2),
    ("dml_delete", 2),
]

# compaction must run (and run often) for its seams to be reachable
# from a short workload; broadcast off so the periodic join plans
# redistribute motions — the material feedback folds that reach the
# io_feedback_write seam
_SERVE_OVERRIDES = ("compact.enabled=true", "compact.interval_s=0.1",
                    "compact.max_delta_parts=2", "ingest.flush_ms=10",
                    "planner.broadcast_threshold=0")

# two segments so redistribute motions exist at all (a singleton store
# gathers everything); segments are slots of the one device
_N_SEGMENTS = 2

_V_FACTOR = 7  # v = k * _V_FACTOR — the bit-identity invariant


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ServerProc:
    """One server subprocess on a store, banner-synchronized."""

    def __init__(self, store: str, inject: str | None = None,
                 timeout_s: float = 60.0, device: str = "cuda"):
        self.port = _free_port()
        env = dict(os.environ)
        env.pop("CBTPU_INJECT", None)
        if inject:
            env["CBTPU_INJECT"] = inject
        cmd = [sys.executable, "-m", "cloudberry_tpu_torch", "--device",
               device, "--store", store, "serve", "--port", str(self.port)]
        for kv in _SERVE_OVERRIDES:
            cmd += ["--set", kv]
        self.proc = subprocess.Popen(
            cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.banner = False
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line and self.proc.poll() is not None:
                return  # died during startup (an armed seam fired early)
            if "serving on" in line:
                self.banner = True
                # keep draining the child's output, so a chatty server
                # never blocks on a full pipe
                threading.Thread(target=self._drain,
                                 name="cbtpu_torch-torture-drain",
                                 daemon=True).start()
                return
        self.kill()
        raise TimeoutError("server did not print its banner in time")

    def _drain(self) -> None:
        for _ in self.proc.stdout:
            pass

    def client(self):
        from cloudberry_tpu_torch.serve.client import Client

        return Client("127.0.0.1", self.port, timeout=30.0)

    def wait_dead(self, timeout_s: float = 30.0) -> int | None:
        try:
            return self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return None

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)


def _drive(server: ServerProc, state: dict, max_stmts: int,
           wall_s: float) -> None:
    """Run the mixed workload until the server dies (the armed seam
    fired) or the budget runs out. Records acks as they arrive —
    state is only ever updated AFTER a response, so it is exactly the
    client's knowledge at the moment of the crash."""
    from cloudberry_tpu_torch.serve.client import ServerError

    c = None
    i = 0
    deadline = time.monotonic() + wall_s
    while i < max_stmts and time.monotonic() < deadline:
        if server.proc.poll() is not None:
            break
        try:
            if c is None:
                c = server.client()
            if not state["setup"]:
                c.sql("create table tort (k bigint, v bigint) "
                      "distributed by (k)")
                c.sql("create table ing (k bigint, v bigint) "
                      "distributed by (k)")
                c.sql("create sequence tseq")
                state["setup"] = True
                continue
            i += 1
            a, b = 2 * i, 2 * i + 1
            if i % 7 == 3 and state["inserted"]:
                # delete a previously ACKED statement's rows
                ka = sorted(state["inserted"])[0]
                kb = ka + 1
                state["delete_submitted"].add((ka, kb))
                c.sql(f"DELETE FROM tort WHERE k >= {ka} AND k <= {kb}")
                state["deleted"].add((ka, kb))
                for k in (ka, kb):
                    state["inserted"].pop(k, None)
            elif i % 5 == 4:
                out = c.sql("SELECT nextval('tseq') AS v")
                state["seq_acked"] = max(state["seq_acked"],
                                         int(out["rows"][0][0]))
            elif i % 9 == 5 and state["inserted"]:
                # a self-join on the NON-distribution key: plans two
                # redistribute motions, whose observed stats fold as
                # material feedback → _FEEDBACK.json persists (the
                # io_feedback_write seam)
                c.sql("SELECT count(a.k) AS n FROM tort a "
                      "JOIN tort b ON a.v = b.v")
            elif i % 4 == 1:
                state["append_submitted"].add(a)
                c.append("ing", [[a, a * _V_FACTOR]], ["k", "v"])
                state["appended"].add(a)
            else:
                state["submitted"].add((a, b))
                c.sql(f"INSERT INTO tort VALUES "
                      f"({a}, {a * _V_FACTOR}), ({b}, {b * _V_FACTOR})")
                for k in (a, b):
                    state["inserted"][k] = k * _V_FACTOR
        except (ServerError, OSError, ValueError):
            # connection severed (the kill) or a refused statement —
            # anything unacked stays unacked; try once more in case the
            # server is still alive (e.g. a retryable refusal)
            try:
                if c is not None:
                    c.close()
            except Exception:  # noqa: BLE001
                pass
            c = None
            if server.proc.poll() is not None:
                break
            time.sleep(0.05)
    if c is not None:
        try:
            c.close()
        except Exception:  # noqa: BLE001
            pass


def _fresh_state() -> dict:
    return {"setup": False, "inserted": {}, "submitted": set(),
            "deleted": set(), "delete_submitted": set(),
            "appended": set(), "append_submitted": set(), "seq_acked": 0}


def _verify(server: ServerProc, state: dict, problems: list) -> None:
    """The restart-side checks, over the wire against the clean server."""
    c = server.client()
    try:
        rows = c.sql("SELECT k, v FROM tort ORDER BY k")["rows"] \
            if state["setup"] else []
        have = {int(r[0]): int(r[1]) for r in rows}
        # 1. every ACKED insert row durable + bit-identical (unless a
        # DELETE was submitted for it — an unacked delete may have
        # committed before the kill)
        del_sub_ks = {k for ab in state["delete_submitted"] for k in ab}
        for k, v in state["inserted"].items():
            if k not in have:
                if k not in del_sub_ks:
                    problems.append(f"ACKED ROW LOST: k={k}")
            elif have[k] != v:
                problems.append(f"ACKED ROW CORRUPT: k={k} "
                                f"v={have[k]} != {v}")
        # 2. no row the workload never submitted
        submitted = {k for ab in state["submitted"] for k in ab}
        for k in have:
            if k not in submitted:
                problems.append(f"PHANTOM ROW: k={k}")
        # 3. bit-identity + all-or-nothing for UNACKED statements
        acked_ks = set(state["inserted"])
        deleted_ks = {k for ab in state["deleted"] for k in ab} \
            | {k for ab in state["delete_submitted"] for k in ab}
        for (a, b) in state["submitted"]:
            if a in acked_ks or a in deleted_ks or b in deleted_ks:
                continue
            ina, inb = a in have, b in have
            if ina != inb:
                problems.append(f"TORN STATEMENT: k={a} present={ina}, "
                                f"k={b} present={inb}")
            for k in (a, b):
                if k in have and have[k] != k * _V_FACTOR:
                    problems.append(f"UNACKED ROW CORRUPT: k={k} "
                                    f"v={have[k]}")
        # 4. acked DELETEs stay deleted; unacked all-or-nothing
        for (ka, kb) in state["deleted"]:
            for k in (ka, kb):
                if k in have:
                    problems.append(f"ACKED DELETE UNDONE: k={k}")
        for (ka, kb) in state["delete_submitted"] - state["deleted"]:
            if (ka in have) != (kb in have):
                problems.append(f"TORN DELETE: k={ka},{kb}")
        # 5. acked ingest appends durable + intact
        if state["setup"]:
            ing = {int(r[0]): int(r[1]) for r in
                   c.sql("SELECT k, v FROM ing ORDER BY k")["rows"]}
            for k in state["appended"]:
                if k not in ing:
                    problems.append(f"ACKED APPEND LOST: k={k}")
            for k, v in ing.items():
                if k not in state["append_submitted"]:
                    problems.append(f"PHANTOM APPEND: k={k}")
                elif v != k * _V_FACTOR:
                    problems.append(f"APPEND CORRUPT: k={k} v={v}")
        # 6. an acked sequence value is never reissued
        if state["setup"] and state["seq_acked"]:
            nxt = int(c.sql("SELECT nextval('tseq') AS v")["rows"][0][0])
            if nxt <= state["seq_acked"]:
                problems.append(f"SEQUENCE REWOUND: nextval {nxt} after "
                                f"acked {state['seq_acked']}")
    finally:
        c.close()


def run_seam(seam: str, hit: int = 6, store: str | None = None,
             max_stmts: int = 200, wall_s: float = 30.0,
             device: str = "cuda") -> dict:
    """Torture one seam end to end, the server on ``device``. Returns
    the verdict record; the run passed iff ``rec['problems'] == []``."""
    import contextlib
    import io

    from cloudberry_tpu_torch.mgmt import cli
    from cloudberry_tpu_torch.storage.fsck import fsck

    tmp = None
    if store is None:
        tmp = tempfile.mkdtemp(prefix=f"tort-{seam}-")
        store = os.path.join(tmp, "store")
    rec = {"seam": seam, "hit": hit, "fired": False, "exit_code": None,
           "acked_inserts": 0, "acked_lost": 0, "problems": [],
           "recovery_ms": None, "fsck_clean": None, "orphans": 0}
    problems = rec["problems"]
    try:
        os.makedirs(store, exist_ok=True)
        with contextlib.redirect_stdout(io.StringIO()):
            if cli.main(["--store", store, "init", "--segments",
                         str(_N_SEGMENTS), "--force"]) != 0:
                raise RuntimeError(f"mgmt init of {store} failed")
        state = _fresh_state()
        srv = ServerProc(store, inject=f"{seam}=crash@{hit}",
                         device=device)
        try:
            _drive(srv, state, max_stmts, wall_s)
            code = srv.wait_dead(timeout_s=20.0)
        finally:
            srv.kill()
        rec["exit_code"] = code if code is not None else srv.proc.poll()
        rec["fired"] = rec["exit_code"] == 137
        rec["acked_inserts"] = len(state["inserted"])
        if not rec["fired"]:
            problems.append(
                f"seam {seam!r} never fired (exit {rec['exit_code']}) — "
                "the workload does not reach it")
        # restart CLEAN (no injection) and verify over the wire
        t0 = time.monotonic()
        srv2 = ServerProc(store, device=device)
        try:
            if not srv2.banner:
                problems.append("restart failed: no banner")
            else:
                _verify(srv2, state, problems)
                rec["recovery_ms"] = round(
                    (time.monotonic() - t0) * 1000.0, 1)
        finally:
            srv2.kill()
        rec["acked_lost"] = sum(
            1 for p in problems
            if p.startswith(("ACKED ROW LOST", "ACKED APPEND LOST")))
        # offline integrity: corruption-free, orphans collectable
        rep = fsck(store, deep=True)
        rec["fsck_clean"] = rep["clean"]
        rec["orphans"] = len(rep["orphans"])
        if not rep["clean"]:
            problems.extend(f"fsck: {p}" for p in rep["problems"])
        rep2 = fsck(store, deep=True, grace_s=0.0, gc=True)
        if rep2["orphans"]:
            problems.append(f"fsck --gc left {len(rep2['orphans'])} "
                            "orphan(s) behind")
        if not fsck(store, deep=True)["clean"]:
            problems.append("fsck not clean after GC")
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return rec


def run_matrix(seams=None, device: str = "cuda") -> list[dict]:
    out = []
    for seam, hit in (seams or MATRIX_SEAMS):
        rec = run_seam(seam, hit=hit, device=device)
        status = "PASS" if not rec["problems"] else "FAIL"
        print(f"{status} {seam}@{hit}: exit={rec['exit_code']} "
              f"acked={rec['acked_inserts']} lost={rec['acked_lost']} "
              f"recovery={rec['recovery_ms']}ms "
              f"orphans={rec['orphans']}", flush=True)
        for p in rec["problems"]:
            print(f"  {p}", flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seam", default=None,
                    help="torture one seam (see MATRIX_SEAMS)")
    ap.add_argument("--hit", type=int, default=None,
                    help="fire on the Nth hit (default: the matrix's)")
    ap.add_argument("--matrix", action="store_true",
                    help="run every matrix seam")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the server processes (default cuda)")
    args = ap.parse_args(argv)
    if args.seam:
        hit = args.hit if args.hit is not None else dict(MATRIX_SEAMS).get(
            args.seam, 6)
        recs = [run_seam(args.seam, hit=hit, device=args.device)]
    elif args.matrix:
        recs = run_matrix(device=args.device)
    else:
        ap.error("pick --seam NAME or --matrix")
    if args.json:
        print(json.dumps(recs, indent=2))
    failed = [r for r in recs if r["problems"]]
    print(f"crash torture: {len(recs) - len(failed)}/{len(recs)} seams "
          f"clean", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
