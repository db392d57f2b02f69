"""Store fsck + orphan GC — the gpcheckcat / pg_checksums offline pass.

``fsck()`` walks a store root and verifies the crash-consistency
contract the write path promises:

- manifest closure: every table's CURRENT resolves to a manifest that
  parses, every partition file it references exists, footer row counts
  agree with the manifest, and delete vectors stay in range;
- store-level JSON (sequences, matviews, topology, feedback, the
  compaction journal) parses — the atomic-replace discipline makes torn
  JSON structurally impossible, so a torn file here is a real defect;
- ``deep=True`` re-reads every referenced column blob and checks its
  footer content checksum (micropartition.verify_file — the
  pg_checksums sweep);
- orphan census: partition files no manifest version references, and
  stale ``tmp*`` droppings from interrupted atomic replaces. Orphans
  are NOT corruption — they are exactly what a kill between a partition
  write and its manifest commit leaves behind — so they report
  separately and never fail the verdict. Journal-pending replacement
  files and anything younger than ``grace_s`` are protected (an
  in-flight commit looks orphaned until CURRENT lands).

The census is fail-safe: a table whose manifest chain could not be
FULLY read (CURRENT torn, an old committed version unreadable, the
_manifests dir unlistable) or that recorded any problem is excluded
from the orphan census entirely (``report["census_skipped"]``) — an
incomplete referenced-set would classify live data files as orphans,
and ``--gc`` would then destroy exactly the table fsck was run to
diagnose. Likewise a torn compaction journal suppresses the census for
every table, because journal-pending protection is unknowable.

``gc=True`` unlinks collectable orphans. The verdict is ``clean`` iff
no corruption problems were found.

The store format, the root file names (``_KEEP``, ``_STORE_JSON``) and
the report are the JAX package's, so either engine's fsck reads a store
the other wrote and both give the same report.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from cloudberry_tpu_torch.storage import micropartition as mp

# store-level JSON files the atomic-replace discipline covers
_STORE_JSON = ("_SEQUENCES.json", "_MATVIEWS.json", "_TOPOLOGY.json",
               "_FEEDBACK.json", "_COMPACTION.json")
# root files that are never orphans (cluster metadata, lock, epoch)
_KEEP = {"cluster.json", "_EPOCH", "_LOCK"} | set(_STORE_JSON)


def _journal_protected(root: str) -> Optional[set[str]]:
    """table-relative paths the compaction journal's pending record still
    owns — their commit may be about to happen on restart. ``None`` when
    the journal EXISTS but cannot be read: protection is then unknowable
    and the orphan census must not run at all."""
    try:
        with open(os.path.join(root, "_COMPACTION.json")) as f:
            rec = json.load(f)
    except FileNotFoundError:
        return set()
    except (OSError, ValueError):
        return None
    pend = rec.get("pending") or {}
    table = pend.get("table")
    if not table:
        return set()
    return {os.path.join(table, f) for f in pend.get("files", ())}


def _check_table(store, root: str, name: str, deep: bool,
                 report: dict) -> Optional[set[str]]:
    """Verify one table; returns the set of referenced partition files
    (across ALL manifest versions — older snapshots pin their files
    until their manifests are pruned), or ``None`` when the manifest
    chain could not be fully read — the referenced-set is then
    incomplete and MUST NOT drive the orphan census (every live file
    would look orphaned and --gc would unlink the table's data)."""
    problems = report["problems"]
    tdir = os.path.join(root, name)
    mdir = os.path.join(tdir, "_manifests")
    referenced: set[str] = set()
    try:
        man = store.read_manifest(name)
    except Exception as e:  # noqa: BLE001 — any parse failure is the finding
        problems.append(f"{name}: CURRENT manifest unreadable: {e}")
        return None
    entry = {"version": man.get("version", 0),
             "partitions": len(man.get("partitions", ())),
             "rows": 0, "checked": 0}
    for part in man.get("partitions", ()):
        fname = part["file"]
        path = os.path.join(tdir, fname)
        referenced.add(fname)
        if not os.path.exists(path):
            problems.append(f"{name}/{fname}: referenced by CURRENT "
                            f"manifest v{man['version']} but missing")
            continue
        try:
            footer = mp.read_footer(path, cipher=store.cipher)
        except Exception as e:  # noqa: BLE001
            problems.append(f"{name}/{fname}: footer unreadable: {e}")
            continue
        if footer.get("num_rows") != part["num_rows"]:
            problems.append(
                f"{name}/{fname}: manifest says {part['num_rows']} rows, "
                f"footer says {footer.get('num_rows')}")
        bad_dv = [r for r in part.get("deleted", ())
                  if not 0 <= r < part["num_rows"]]
        if bad_dv:
            problems.append(f"{name}/{fname}: delete vector rows "
                            f"{bad_dv[:4]} out of range "
                            f"[0, {part['num_rows']})")
        entry["rows"] += part["num_rows"] - len(part.get("deleted", ()))
        if deep:
            for p in mp.verify_file(path, cipher=store.cipher):
                problems.append(f"{name}/{fname}: {p}")
            entry["checked"] += 1
    # older manifest versions pin their files too (versioned reads)
    chain_complete = True
    try:
        for mf in os.listdir(mdir):
            if mf.startswith("v") and mf.endswith(".json"):
                try:
                    v = int(mf[1:-5])
                    old = store.read_manifest(name, v)
                except Exception:  # noqa: BLE001
                    # AHEAD of CURRENT: expected crash residue (possibly
                    # torn, never committed). At or BEHIND: a committed
                    # snapshot whose pins we cannot enumerate — the
                    # referenced-set is incomplete, census unsafe.
                    if mf[1:-5].isdigit() and int(mf[1:-5]) <= entry["version"]:
                        problems.append(
                            f"{name}/_manifests/{mf}: committed manifest "
                            "unreadable")
                        chain_complete = False
                    continue
                referenced.update(p["file"]
                                  for p in old.get("partitions", ()))
    except OSError:
        chain_complete = False  # cannot enumerate versions at all
    report["tables"][name] = entry
    return referenced if chain_complete else None


def fsck(root: str, cipher=None, deep: bool = False,
         grace_s: float = 300.0, gc: bool = False,
         now: Optional[float] = None) -> dict:
    """Verify a store root; optionally collect orphans. Returns the
    report dict (see module docstring); ``report["clean"]`` is the
    verdict."""
    from cloudberry_tpu_torch.storage.table_store import TableStore

    store = TableStore(root)
    store.cipher = cipher
    store.verify_checksums = True
    now = time.time() if now is None else now
    report: dict = {"root": root, "tables": {}, "problems": [],
                    "orphans": [], "collected": [], "census_skipped": []}
    protected = _journal_protected(root)

    for name in sorted(os.listdir(root)):
        tdir = os.path.join(root, name)
        if not os.path.isdir(os.path.join(tdir, "_manifests")):
            continue
        n_problems = len(report["problems"])
        referenced = _check_table(store, root, name, deep, report)
        # fail-safe census: only a table whose manifest chain was FULLY
        # read and that reported zero problems may have its unreferenced
        # files classified as orphans — anything else and "orphan" may
        # mean "live file we failed to account for", which --gc would
        # then destroy. A torn compaction journal (protected is None)
        # suppresses the census store-wide for the same reason.
        if (referenced is None or protected is None
                or len(report["problems"]) > n_problems):
            report["census_skipped"].append(name)
            continue
        # orphan census: partition files no manifest version references
        for fname in sorted(os.listdir(tdir)):
            rel = os.path.join(name, fname)
            full = os.path.join(tdir, fname)
            is_part = fname.startswith("part-") and fname.endswith(".cbmp")
            is_tmp = fname.startswith("tmp")
            if not (is_part or is_tmp) or fname in referenced:
                continue
            if rel in protected:
                continue
            try:
                age = now - os.path.getmtime(full)
            except OSError:
                continue  # vanished mid-walk — already collected
            report["orphans"].append(
                {"path": rel, "age_s": round(age, 1),
                 "collectable": age >= grace_s})
        # interrupted atomic replaces under _manifests, plus manifest
        # versions AHEAD of CURRENT — the residue of a crash between the
        # v{N}.json write and the CURRENT swap (possibly torn; never
        # reachable, so an orphan rather than corruption)
        cur = report["tables"].get(name, {}).get("version", 0)
        mdir = os.path.join(tdir, "_manifests")
        for fname in sorted(os.listdir(mdir)):
            ahead = False
            if fname.startswith("v") and fname.endswith(".json"):
                try:
                    ahead = int(fname[1:-5]) > cur
                except ValueError:
                    pass
            if not (fname.startswith("tmp") or ahead):
                continue
            full = os.path.join(mdir, fname)
            try:
                age = now - os.path.getmtime(full)
            except OSError:
                continue
            report["orphans"].append(
                {"path": os.path.join(name, "_manifests", fname),
                 "age_s": round(age, 1), "collectable": age >= grace_s})

    # store-level JSON must parse (atomic replace ⇒ torn = defect);
    # stale tmp files at the root are interrupted replaces
    for fname in sorted(os.listdir(root)):
        full = os.path.join(root, fname)
        if fname in _STORE_JSON:
            try:
                with open(full) as f:
                    json.load(f)
            except ValueError as e:
                report["problems"].append(f"{fname}: torn JSON: {e}")
            except OSError as e:
                report["problems"].append(f"{fname}: unreadable: {e}")
        elif fname.startswith("tmp") and os.path.isfile(full):
            try:
                age = now - os.path.getmtime(full)
            except OSError:
                continue
            report["orphans"].append(
                {"path": fname, "age_s": round(age, 1),
                 "collectable": age >= grace_s})

    if gc:
        for o in report["orphans"]:
            if not o["collectable"]:
                continue
            try:
                os.unlink(os.path.join(root, o["path"]))
                report["collected"].append(o["path"])
            except OSError:
                pass  # raced another collector / vanished — fine
        report["orphans"] = [o for o in report["orphans"]
                             if o["path"] not in set(report["collected"])]

    report["clean"] = not report["problems"]
    return report
