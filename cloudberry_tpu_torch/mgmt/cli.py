"""Management CLI — the gpMgmt plane analog
(`python -m cloudberry_tpu_torch`).

Reference tools → subcommands (SURVEY §2.7):
- gpinitsystem → ``init``      (create a cluster: store root + topology)
- gpstate      → ``state``     (topology, devices, health, tables)
- FTS probe    → ``probe``     (one health probe round)
- gpexpand /
  gpshrink     → ``expand``    (resize topology, offline or ``--online``;
                                reports the moved-row fraction, which
                                jump_consistent_hash keeps ≈ delta/N — the
                                gpexpand minimal-movement promise,
                                cdbhash.c:55)
- gpcheckcat   → ``check``     (storage/catalog consistency scan)
- pg_checksums → ``fsck``      (store integrity + orphan GC)
- psql -c      → ``sql``       (run a statement against the cluster
                                store, in process or ``--connect`` to a
                                running server)
- postmaster   → ``serve``     (the socket server, serve/server.py)
- gpfdist      → ``fdist``     (the scatter file server, serve/fdist.py)
- mcp-server   → ``mcp``       (the AI-agent tool surface, serve/mcp.py)

The "cluster" is a store directory plus ``cluster.json`` (the
gp_segment_configuration analog). Segments are slots of one device, so
start/stop are process-lifecycle no-ops; recovery is re-execution (see
parallel/health.py). Every command that runs statements runs them on
``--device`` (default ``cuda``; the CPU tests pass ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _cluster_path(store: str) -> str:
    return os.path.join(store, "cluster.json")


def load_cluster(store: str) -> dict:
    try:
        with open(_cluster_path(store)) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SystemExit(
            f"error: no cluster at {store!r} — run "
            f"`python -m cloudberry_tpu_torch --store {store} init` first")


def _enc_key() -> str | None:
    """TDE cluster key for CLI entry points: --encryption-key or the
    CBTPU_ENCRYPTION_KEY environment (the keyring-unlock analog)."""
    return _ENC_KEY or os.environ.get("CBTPU_ENCRYPTION_KEY") or None


_ENC_KEY: str | None = None


def _store(root: str):
    """A TableStore honoring the TDE key (every direct CLI store open)."""
    from cloudberry_tpu_torch.storage.table_store import TableStore
    from cloudberry_tpu_torch.utils.tde import make_cipher

    ts = TableStore(root)
    ts.cipher = make_cipher(_enc_key())
    return ts


def cluster_config(store: str):
    """The one Config a cluster store implies — every entry point that
    serves the store must build it identically or drift apart."""
    from cloudberry_tpu_torch.config import Config

    cfg = load_cluster(store)
    over = {"storage.root": store}
    if _enc_key():
        over["storage.encryption_key"] = _enc_key()
    return Config(n_segments=cfg["n_segments"]).with_overrides(**over)


# the device every in-process session of this invocation runs on
# (--device; ``main`` sets it)
_DEVICE = "cuda"


def _open_session(store: str):
    import cloudberry_tpu_torch as cb
    from cloudberry_tpu_torch.config import Config

    cfg = load_cluster(store)
    s = cb.Session(Config(n_segments=cfg["n_segments"]), device=_DEVICE)
    ts = _store(store)
    for name in sorted(os.listdir(store)):
        if os.path.isdir(os.path.join(store, name, "_manifests")):
            ts.load_table(s.catalog, name)
    return s, ts


def cmd_init(args) -> int:
    os.makedirs(args.store, exist_ok=True)
    if os.path.exists(_cluster_path(args.store)) and not args.force:
        print(f"error: cluster already initialized at {args.store}",
              file=sys.stderr)
        return 1
    cfg = {"n_segments": args.segments, "created": time.time(),
           "format": 1}
    with open(_cluster_path(args.store), "w") as f:
        json.dump(cfg, f)
    print(f"initialized cluster: {args.segments} segments at {args.store}")
    return 0


def cmd_state(args) -> int:
    import torch

    from cloudberry_tpu_torch.parallel import health

    cfg = load_cluster(args.store)
    s, ts = _open_session(args.store)
    n_dev = torch.cuda.device_count() if s.device.type == "cuda" else 1
    r = health.probe(s)
    print(f"cluster store:   {args.store}")
    print(f"segments:        {cfg['n_segments']}")
    print(f"devices visible: {n_dev} ({s.device.type})")
    print(f"health probe:    {'OK' if r.ok else 'FAILED: ' + str(r.error)}"
          f" ({r.latency_s * 1000:.1f} ms)")
    for name in sorted(os.listdir(args.store)):
        mdir = os.path.join(args.store, name, "_manifests")
        if os.path.isdir(mdir):
            man = ts.read_manifest(name)
            rows = sum(p["num_rows"] - len(p["deleted"])
                       for p in man["partitions"])
            print(f"table {name}: v{man['version']}, "
                  f"{len(man['partitions'])} partitions, {rows} rows")
    for sname in ts.sequence_names():
        seq = ts._read_sequences()[sname]
        print(f"sequence {sname}: next {seq['next']} "
              f"(increment {seq['inc']})")
    return 0


def cmd_probe(args) -> int:
    import cloudberry_tpu_torch as cb
    from cloudberry_tpu_torch.parallel import health

    r = health.probe(cb.Session(device=_DEVICE))
    print(json.dumps({"ok": r.ok, "devices": r.n_devices,
                      "latency_ms": round(r.latency_s * 1000, 2),
                      "error": r.error}))
    return 0 if r.ok else 1


def cmd_expand(args) -> int:
    import numpy as np

    from cloudberry_tpu_torch.utils import hashing

    cfg = load_cluster(args.store)
    old_n, new_n = cfg["n_segments"], args.segments
    if getattr(args, "online", False):
        return _expand_online(args, cfg, old_n, new_n)
    s, ts = _open_session(args.store)
    moved_frac = []
    for name, t in s.catalog.tables.items():
        if t.policy.kind != "hashed" or t.num_rows == 0:
            continue
        cols = [np.asarray(t.data[k]) for k in t.policy.keys]
        h = hashing.hash_columns_np(cols)
        a = hashing.jump_consistent_hash_np(h, old_n)
        b = hashing.jump_consistent_hash_np(h, new_n)
        moved_frac.append((name, float((a != b).mean())))
    cfg["n_segments"] = new_n
    with open(_cluster_path(args.store), "w") as f:
        json.dump(cfg, f)
    verb = "expanded" if new_n > old_n else "shrunk"
    print(f"{verb} cluster {old_n} → {new_n} segments")
    for name, frac in moved_frac:
        print(f"  {name}: {frac * 100:.1f}% of rows move "
              f"(jump-hash minimal movement)")
    return 0


def _expand_online(args, cfg: dict, old_n: int, new_n: int) -> int:
    """The gpexpand-made-online path (parallel/topology.py): create a
    successor epoch, move the jump-hash delta rows partition-by-
    partition (OCC-committed chunks, journal-resumable, throttled), cut
    over, and report the measured moved-row fraction against the
    delta/N minimal-movement bound. A server process on the same store
    adopts the new epoch at its next statement — no downtime. The
    offline path (no --online) keeps working and lands on the identical
    derived placement."""
    import cloudberry_tpu_torch as cb

    if new_n == old_n:
        print(f"cluster already at {new_n} segments")
        return 0
    s = cb.Session(cluster_config(args.store), device=_DEVICE)
    topo = s._topology
    topo.begin(new_n)

    def report(st):
        frac = st.moved_rows / max(st.total_rows, 1)
        print(f"  rebalance: {st.tables_done}/{st.tables_total} tables, "
              f"{st.moved_rows} rows moved ({frac * 100:.1f}%)",
              flush=True)

    topo.rebalance(chunk_rows=args.chunk_rows or None,
                   throttle_s=args.throttle_s, progress=report)
    out = topo.cutover()
    cfg["n_segments"] = new_n
    with open(_cluster_path(args.store), "w") as f:
        json.dump(cfg, f)
    verb = "expanded" if new_n > old_n else "shrunk"
    reb = out["rebalance"]
    frac = reb["moved_rows"] / max(reb["total_rows"], 1)
    bound = reb["minimal_bound"]
    print(f"{verb} cluster {old_n} → {new_n} segments ONLINE "
          f"(epoch {out['epoch']}, cutover {out['cutover_ms']:.1f} ms)")
    if reb["total_rows"] and bound:
        print(f"  moved {reb['moved_rows']} of {reb['total_rows']} rows "
              f"({frac * 100:.1f}%) vs delta/N minimal-movement bound "
              f"{bound * 100:.1f}% ({frac / bound:.2f}x)")
    else:
        print("  no hashed rows to move")
    return 0


def cmd_check(args) -> int:
    """Storage consistency scan (gpcheckcat analog): every partition file
    must parse, row counts and dictionary code ranges must agree."""
    from cloudberry_tpu_torch.storage import micropartition as mp

    ts = _store(args.store)
    problems = 0
    for name in sorted(os.listdir(args.store)):
        mdir = os.path.join(args.store, name, "_manifests")
        if not os.path.isdir(mdir):
            continue
        man = ts.read_manifest(name)
        for part in man["partitions"]:
            path = os.path.join(args.store, name, part["file"])
            try:
                footer = mp.read_footer(path, cipher=ts.cipher)
                if footer["num_rows"] != part["num_rows"]:
                    print(f"MISMATCH {name}/{part['file']}: manifest rows "
                          f"{part['num_rows']} != footer {footer['num_rows']}")
                    problems += 1
                cols = mp.read_columns(path, cipher=ts.cipher, verify=True)
                for cname, values in man["dicts"].items():
                    if cname in cols and len(cols[cname]) \
                            and cols[cname].max() >= len(values):
                        print(f"BAD DICT {name}/{part['file']}: column "
                              f"{cname} code {cols[cname].max()} out of "
                              f"range {len(values)}")
                        problems += 1
            except Exception as e:  # noqa: BLE001
                print(f"CORRUPT {name}/{part['file']}: {e}")
                problems += 1
    print(f"check complete: {problems} problem(s)")
    return 0 if problems == 0 else 1


def cmd_fsck(args) -> int:
    """Store integrity scan + orphan GC (pg_checksums / fsck analog):
    manifest closure, store-JSON parse, optional deep checksum sweep,
    and collection of crash residue (orphan partitions, stale tmp
    files) past the grace window."""
    from cloudberry_tpu_torch.storage.fsck import fsck
    from cloudberry_tpu_torch.utils.tde import make_cipher

    report = fsck(args.store, cipher=make_cipher(_enc_key()),
                  deep=args.deep, grace_s=args.grace_s, gc=args.gc)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for name, t in sorted(report["tables"].items()):
            print(f"table {name}: v{t['version']}, {t['partitions']} "
                  f"partitions, {t['rows']} live rows"
                  + (f", {t['checked']} deep-checked" if args.deep else ""))
        for p in report["problems"]:
            print(f"PROBLEM {p}")
        for o in report["orphans"]:
            print(f"orphan {o['path']} (age {o['age_s']}s"
                  f"{', collectable' if o['collectable'] else ''})")
        for name in report["census_skipped"]:
            print(f"census skipped for {name}: manifest chain unreadable "
                  "or problems found — orphan GC disabled for this table")
        for c in report["collected"]:
            print(f"collected {c}")
        print(f"fsck {'clean' if report['clean'] else 'NOT CLEAN'}: "
              f"{len(report['problems'])} problem(s), "
              f"{len(report['orphans'])} orphan(s), "
              f"{len(report['collected'])} collected")
    return 0 if report["clean"] else 1


def cmd_serve(args) -> int:
    """Run the socket serving layer (the postmaster/tcop analog): one
    process owns the session; clients connect over TCP."""
    from cloudberry_tpu_torch.serve import Server
    from cloudberry_tpu_torch.utils import faultinject

    # crash-torture arming: the harness launches this very entry point
    # with CBTPU_INJECT set, so the faults land inside the REAL server
    # process it is about to kill (never armed in normal operation)
    n_armed = faultinject.arm_from_env()
    cfg = cluster_config(args.store)
    for kv in getattr(args, "set", None) or []:
        key, _, val = kv.partition("=")
        try:
            val = json.loads(val)
        except ValueError:
            pass  # bare strings stay strings
        cfg = cfg.with_overrides(**{key: val})
    srv = Server(config=cfg,
                 host=args.host, port=args.port,
                 read_only=getattr(args, "standby", False),
                 auth_token=getattr(args, "auth_token", None),
                 device=_DEVICE)
    if n_armed:
        print(f"fault injection armed: {n_armed} seam(s) from "
              "CBTPU_INJECT", flush=True)
    role = "standby (read-only)" if srv.read_only else "primary"
    print(f"serving on {srv.host}:{srv.port} (store {args.store}, "
          f"{srv.session.config.n_segments} segments, {role}, "
          f"{srv.session.device})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        # smart shutdown: finish accepted work, refuse new requests with
        # the retryable drain error, then close (Ctrl-C twice to force)
        srv.stop(drain_s=10.0)
    return 0


def cmd_sql(args) -> int:
    if args.connect:
        from cloudberry_tpu_torch.serve import Client

        host, _, port = args.connect.rpartition(":")
        with Client(host or "127.0.0.1", int(port)) as c:
            out = c.sql(args.query)
        if "rows" in out:
            print("\t".join(out["columns"]))
            for row in out["rows"]:
                print("\t".join(str(v) for v in row))
        else:
            print(out.get("status", ""))
        return 0
    s, ts = _open_session(args.store)
    versions = {n: getattr(t, "_version", 0)
                for n, t in s.catalog.tables.items()}
    out = s.sql(args.query)
    if hasattr(out, "to_pandas"):
        print(out.to_pandas().to_string(index=False))
    else:
        print(out)  # DDL/DML status tag
        if args.save:
            # persist only tables the statement actually changed
            for n, t in s.catalog.tables.items():
                if getattr(t, "_version", 0) != versions.get(n):
                    ts.save_table(t)
            # dropped tables: remove their store directories too
            import shutil

            for n in set(versions) - set(s.catalog.tables):
                tdir = os.path.join(args.store, n)
                if os.path.isdir(os.path.join(tdir, "_manifests")):
                    shutil.rmtree(tdir)
    return 0


def cmd_fdist(args) -> int:
    from cloudberry_tpu_torch.serve.fdist import main as fdist_main

    fdist_main(args.root, args.port, args.host)
    return 0


def cmd_mcp(args) -> int:
    """Run the MCP stdio server (the mcp-server analog): AI agents speak
    JSON-RPC on stdin/stdout; the engine is this process's cluster store
    (a session on ``--device``), or a running socket server via
    --connect."""
    from cloudberry_tpu_torch.serve.mcp import (McpServer, SessionEngine,
                                                WireEngine)

    if args.connect:
        host, _, port = args.connect.rpartition(":")
        engine = WireEngine(host or "127.0.0.1", int(port))
    else:
        import cloudberry_tpu_torch as cb

        engine = SessionEngine(cb.Session(cluster_config(args.store),
                                          device=_DEVICE))
    McpServer(engine).serve_stdio()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cloudberry_tpu_torch",
        description="MPP SQL cluster management (PyTorch + CUDA)")
    p.add_argument("--store", default=os.environ.get("CBTPU_STORE", "./cbtpu"),
                   help="cluster store directory")
    p.add_argument("--device", default="cuda",
                   help="device of the in-process sessions and the "
                        "server (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--encryption-key", default=None,
                   help="TDE cluster key (or CBTPU_ENCRYPTION_KEY env) — "
                        "required to open an encrypted store")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("init", help="create a cluster (gpinitsystem)")
    pi.add_argument("--segments", type=int, default=1)
    pi.add_argument("--force", action="store_true")
    pi.set_defaults(fn=cmd_init)

    ps = sub.add_parser("state", help="cluster status (gpstate)")
    ps.set_defaults(fn=cmd_state)

    pp = sub.add_parser("probe", help="health probe (FTS)")
    pp.set_defaults(fn=cmd_probe)

    pe = sub.add_parser("expand", help="resize segments (gpexpand/gpshrink)")
    pe.add_argument("--segments", type=int, required=True)
    pe.add_argument("--online", action="store_true",
                    help="epoch-versioned online resize: background "
                         "minimal-delta rebalance + atomic cutover; a "
                         "serving cluster adopts without downtime "
                         "(resumable if interrupted)")
    pe.add_argument("--chunk-rows", type=int, default=0,
                    help="rows per rebalance chunk (0 = config default)")
    pe.add_argument("--throttle-s", type=float, default=None,
                    help="sleep between rebalance chunks (background "
                         "politeness on a serving cluster; default: "
                         "config.topology.throttle_s)")
    pe.set_defaults(fn=cmd_expand)

    pc = sub.add_parser("check", help="storage consistency (gpcheckcat)")
    pc.set_defaults(fn=cmd_check)

    pk = sub.add_parser("fsck", help="store integrity + orphan GC "
                                     "(pg_checksums analog)")
    pk.add_argument("--deep", action="store_true",
                    help="re-read every column blob and verify its "
                         "footer content checksum")
    pk.add_argument("--gc", action="store_true",
                    help="collect orphans past the grace window")
    pk.add_argument("--grace-s", type=float, default=300.0,
                    help="age before crash residue becomes collectable "
                         "(protects in-flight commits; default 300)")
    pk.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    pk.set_defaults(fn=cmd_fsck)

    pq = sub.add_parser("sql", help="run a statement")
    pq.add_argument("query")
    pq.add_argument("--save", action="store_true",
                    help="persist modified tables back to the store")
    pq.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="send to a running server instead of in-process")
    pq.set_defaults(fn=cmd_sql)

    pv = sub.add_parser("serve", help="run the socket server (tcop analog)")
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=15432)
    pv.add_argument("--standby", action="store_true",
                    help="hot standby: serve reads over the shared store, "
                         "refuse writes")
    pv.add_argument("--auth-token", default=None,
                    help="require {\"auth\": token} before requests "
                         "(failed logins lock the address out)")
    pv.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="config override (repeatable), e.g. "
                         "--set compact.enabled=true — values parse as "
                         "JSON, falling back to bare strings")
    pv.set_defaults(fn=cmd_serve)

    pf = sub.add_parser("fdist",
                        help="scatter file server (gpfdist analog)")
    pf.add_argument("--root", default=".")
    pf.add_argument("--port", type=int, default=8800)
    pf.add_argument("--host", default="0.0.0.0")
    pf.set_defaults(fn=cmd_fdist)

    pm = sub.add_parser("mcp", help="MCP stdio server (AI-agent surface)")
    pm.add_argument("--connect", default=None, metavar="HOST:PORT",
                    help="back onto a running server instead of in-process")
    pm.set_defaults(fn=cmd_mcp)

    args = p.parse_args(argv)
    global _ENC_KEY, _DEVICE
    _ENC_KEY = args.encryption_key or None
    _DEVICE = args.device
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
