"""Offline flight-bundle replay — re-execute a captured slow statement
and assert bit-identical results.

The flight recorder (cloudberry_tpu_torch/obs/flightrec.py) captures a
slow or erroring statement's debug bundle, including a sha256 digest
over the DECODED result columns. This tool closes the forensics loop:
given a bundle (a file saved from ``meta "flight"``, or the export list
itself), it opens a fresh session against the bundle's durable store,
re-executes the sql, and compares digests — the replay contract:

    same store version + same statement text + same config shape
    ⇒ the same bytes, or the replay FAILS loudly.

A digest mismatch means the store moved underneath (a later commit),
the engine regressed, or the bundle is from a different cluster — all
three are exactly what a forensics session needs to know first. The
store format and the bundle are the JAX package's, so a bundle that
either engine captured replays in the other over the same store.

Usage:
    python -m cloudberry_tpu_torch.tools.flight_replay bundle.json
        [--index N] [--root DIR] [--segments N] [--device cuda|cpu]

``bundle.json`` may hold one bundle, a list, or a ``meta "flight"``
response ({"flights": [...]}); --index picks from a list (default 0,
the newest). --root / --segments override the bundle's recorded store
root and segment count (e.g. the store was copied for offline
analysis). The replay session runs on CUDA unless ``--device cpu``.
Exit 0 on a bit-identical replay, 1 on mismatch, 2 on an unreplayable
bundle (no store root, no result digest, or non-JSON bind params).
"""

from __future__ import annotations

import argparse
import json
import sys


def pick_bundle(doc, index: int = 0) -> dict:
    """One bundle out of whatever shape the file holds."""
    if isinstance(doc, dict) and "flights" in doc:
        doc = doc["flights"]
    if isinstance(doc, dict) and "meta" in doc \
            and isinstance(doc["meta"], dict):
        doc = doc["meta"].get("flights", doc)
    if isinstance(doc, list):
        if not doc:
            raise ValueError("empty flight list")
        return doc[index]
    if isinstance(doc, dict):
        return doc
    raise ValueError(f"unrecognized bundle document: {type(doc).__name__}")


def replay(bundle: dict, session=None, root: str | None = None,
           n_segments: int | None = None, device=None) -> dict:
    """Re-execute one bundle; returns the verdict record:
    ``{"ok": bool, "expected": digest, "got": digest, ...}``.
    ``session`` overrides session construction (tests pass the live
    session to assert replay-on-the-same-engine first); otherwise a
    fresh session opens on ``device`` (default: CUDA)."""
    from cloudberry_tpu_torch.obs import flightrec

    expected = bundle.get("result")
    if expected is None:
        return {"ok": False, "unreplayable":
                "bundle has no result digest (errored or DML statement)"}
    params = bundle.get("params") or {}
    if session is None:
        store_root = root or bundle.get("storage_root")
        if not store_root:
            return {"ok": False, "unreplayable":
                    "bundle has no storage root (in-memory session) — "
                    "pass --root to point at a copied store"}
        import cloudberry_tpu_torch as cb
        from cloudberry_tpu_torch.config import Config

        nseg = n_segments if n_segments is not None \
            else int(bundle.get("n_segments", 1))
        session = cb.Session(Config().with_overrides(**{
            "storage.root": store_root, "n_segments": nseg}),
            device=device)
    out = session.sql(bundle["sql"], **params)
    got = flightrec.result_digest(out)
    ok = bool(got is not None
              and got["sha256"] == expected.get("sha256")
              and got["rows"] == expected.get("rows"))
    return {"ok": ok, "expected": expected, "got": got,
            "sql": bundle["sql"][:200]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bundle", help="bundle JSON file (one bundle, a "
                                   "list, or a meta 'flight' response)")
    ap.add_argument("--index", type=int, default=0,
                    help="which bundle when the file holds a list "
                         "(0 = newest)")
    ap.add_argument("--root", default=None,
                    help="override the bundle's storage root")
    ap.add_argument("--segments", type=int, default=None,
                    help="override the bundle's segment count")
    ap.add_argument("--device", default="cuda",
                    help="device of the replay session (default cuda; cpu "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    with open(args.bundle) as fh:
        bundle = pick_bundle(json.load(fh), args.index)
    verdict = replay(bundle, root=args.root, n_segments=args.segments,
                     device=args.device)
    if verdict.get("unreplayable"):
        print(f"UNREPLAYABLE: {verdict['unreplayable']}", file=sys.stderr)
        return 2
    if verdict["ok"]:
        print(f"OK: bit-identical replay "
              f"({verdict['expected']['rows']} rows, "
              f"sha256 {verdict['expected']['sha256'][:16]}…)")
        return 0
    print("MISMATCH:", file=sys.stderr)
    print(f"  expected {verdict['expected']}", file=sys.stderr)
    print(f"  got      {verdict['got']}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
