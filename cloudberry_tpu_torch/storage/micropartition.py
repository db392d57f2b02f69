"""Micro-partition files — the PAX / AO-columnar analog.

The reference's columnar storage (contrib/pax_storage: ORC-like micro
partitions with protobuf footer metadata, min/max + bloom stats, zstd/RLE
encodings; and AO varblocks, src/backend/access/appendonly/README.md) maps
here to immutable single-file micro-partitions:

    [magic][column blocks...][footer JSON][footer_len: u32][magic]

Footer carries schema, per-column encoding + byte ranges + min/max stats, and
the string dictionaries. Readers prune whole files on stats before touching
column bytes, then read only requested columns (column projection) — the same
two moves PAX's sparse filters make (micro_partition_stats.cc). Encodings:
raw | zlib | rle (run-length + zlib'd runs), chosen per column by measured
size. zstd used when the zstandard package imports, zlib as the fallback —
mirroring the reference's zstd/zlib ladder.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Iterable, Optional

import numpy as np

try:
    import zstandard as _zstd
except Exception:  # pragma: no cover
    _zstd = None

# zstd contexts are PER THREAD: a context is stateful and not safe for
# concurrent calls, the scan pipeline (exec/scanpipe.py) decodes columns
# in parallel across a reader pool, and a large write encodes its
# columns in parallel (write_micropartition).
# The native codecs (zstd, zlib, the dvarint C path) all release the
# GIL on big blocks, so per-thread contexts are what actually lets the
# pool overlap — a single shared context would serialize right back.
_TLS = threading.local()


def _zstd_dctx():
    d = getattr(_TLS, "zd", None)
    if d is None:
        d = _TLS.zd = _zstd.ZstdDecompressor()
    return d


def _zstd_cctx():
    c = getattr(_TLS, "zc", None)
    if c is None:
        c = _TLS.zc = _zstd.ZstdCompressor(level=3)
    return c

from cloudberry_tpu_torch.columnar.dictionary import StringDictionary
from cloudberry_tpu_torch.lifecycle import StorageCorruptionError
from cloudberry_tpu_torch.storage import iofault
from cloudberry_tpu_torch.types import DType, Field, Schema, SqlType
from cloudberry_tpu_torch.utils.faultinject import fault_point

MAGIC = b"CBTPMP1\n"
MAGIC_ENC = b"CBMPENC1"  # TDE-encrypted container (utils/tde.py)

# Verified-clean memo for the scan-path checksum check: partition files
# are IMMUTABLE once committed (append/compact only ever write NEW
# files), and a repeat read on a warm page cache re-checks the same
# cached bytes — it can detect nothing the first check did not. So each
# (file, column) verifies ONCE per process per on-disk identity
# (size + mtime_ns key the entry; a rewritten or bit-flipped-then-
# retouched file re-verifies), which is the reference discipline:
# pg_checksums-protected pages verify when they ENTER the buffer pool,
# not on every buffer access. fsck's deep pass (verify_file) never
# consults the memo — offline verification is always full. Benign
# races only (two threads may both verify a key); cleared wholesale at
# the cap because correctness never depends on a hit.
_VERIFIED_CAP = 65536
_verified: dict[tuple, bool] = {}


def _compress(raw: bytes, codec: str) -> bytes:
    if codec == "zstd":
        return _zstd_cctx().compress(raw)
    if codec == "zlib":
        return zlib.compress(raw, 6)
    return raw


def _decompress(buf: bytes, codec: str) -> bytes:
    if codec == "zstd":
        return _zstd_dctx().decompress(buf)
    if codec == "zlib":
        return zlib.decompress(buf)
    return buf


def decode_column(enc: dict, blob: bytes, dtype: np.dtype,
                  num_rows: int) -> np.ndarray:
    """Decode ONE column's stored blob to its array — the unit of work
    the scan pipeline's reader pool parallelizes (thread-safe: per-
    thread decompression contexts, native dvarint path where the
    toolchain built it)."""
    raw = _decompress(blob, enc["codec"])
    if enc["encoding"] == "rle":
        return _rle_decode(raw, enc["n_runs"], dtype, num_rows)
    if enc["encoding"] == "dvarint":
        from cloudberry_tpu_torch import native

        return native.dvarint_decode(raw, num_rows).astype(dtype)
    return np.frombuffer(raw, dtype=dtype, count=num_rows).copy()


def _rle_encode(arr: np.ndarray) -> Optional[tuple[bytes, int]]:
    """Run-length encode; None if it wouldn't help (too many runs)."""
    if len(arr) == 0:
        return b"", 0
    change = np.nonzero(np.diff(arr))[0]
    n_runs = len(change) + 1
    if n_runs * 12 >= arr.nbytes:
        return None
    starts = np.concatenate([[0], change + 1])
    lengths = np.diff(np.concatenate([starts, [len(arr)]]))
    values = arr[starts]
    raw = lengths.astype(np.int32).tobytes() + values.tobytes()
    return raw, n_runs


def _rle_decode(raw: bytes, n_runs: int, dtype: np.dtype, n: int) -> np.ndarray:
    lengths = np.frombuffer(raw, dtype=np.int32, count=n_runs)
    values = np.frombuffer(raw, dtype=dtype, offset=n_runs * 4, count=n_runs)
    return np.repeat(values, lengths)[:n]


# A partition of at least this many rows encodes its columns on a
# thread pool: compression, checksums, the delta-varint codec and the
# numpy passes release the GIL, and the bytes written are the same.
PARALLEL_ENCODE_ROWS = 1 << 16


def _encode_column(f: Field, arr: np.ndarray, codec: str,
                   dicts: dict[str, StringDictionary]) -> tuple[dict, bytes]:
    """One column's footer entry and stored blob."""
    enc: dict = {"name": f.name, "codec": codec}
    rle = _rle_encode(arr)
    dv = None
    if rle is None and arr.dtype == np.int64 and len(arr):
        # delta varint (native codec) wins on keys/sorted-ish int64
        from cloudberry_tpu_torch import native

        dv = native.dvarint_encode(arr)
        if len(dv) * 2 > arr.nbytes:
            dv = None  # not worth it
    if rle is not None:
        raw, n_runs = rle
        enc["encoding"] = "rle"
        enc["n_runs"] = n_runs
    elif dv is not None:
        raw = dv
        enc["encoding"] = "dvarint"
    else:
        raw = arr.tobytes()
        enc["encoding"] = "raw"
    blob = _compress(raw, codec)
    if len(blob) >= len(raw) and enc["encoding"] == "raw":
        blob = raw
        enc["codec"] = "none"
    enc["offset"] = None  # set by the writer, in column order
    enc["length"] = len(blob)
    # content checksum of the stored blob (the pg_checksums analog):
    # verified at decode behind TableStore.verify_checksums and by the
    # JAX package's `mgmt fsck` — a flipped bit is a typed
    # StorageCorruptionError, never a wrong answer
    enc["cksum"] = iofault.content_hash(blob)
    if f.dtype != DType.STRING and len(arr) and arr.dtype.kind in "iuf":
        enc["min"] = _json_num(arr.min())
        enc["max"] = _json_num(arr.max())
        if arr.dtype.kind in "iu":
            # bloom filter for equality pruning (PAX
            # micro_partition_stats.cc bloom move): point predicates
            # skip files min/max can't exclude
            enc["bloom"] = _bloom_build(arr)
    if f.dtype == DType.STRING and f.name in dicts:
        enc["dictionary"] = dicts[f.name].values
    return enc, blob


def write_micropartition(path: str, data: dict[str, np.ndarray],
                         schema: Schema,
                         dicts: dict[str, StringDictionary] | None = None,
                         codec: str | None = None,
                         cipher=None) -> dict:
    """Write one immutable micro-partition; returns its footer dict.
    ``cipher`` (TDE, the pg_tde analog): an object with
    encrypt(bytes)/decrypt(bytes) — the whole file encrypts, because
    footers carry min/max stats and string dictionaries (data, not just
    metadata)."""
    dicts = dicts or {}
    codec = codec or ("zstd" if _zstd is not None else "zlib")
    n = len(next(iter(data.values()))) if data else 0
    fields = list(schema.fields)

    def one(f):
        return _encode_column(f, np.ascontiguousarray(data[f.name]), codec,
                              dicts)

    if n >= PARALLEL_ENCODE_ROWS and len(fields) > 1:
        from concurrent.futures import ThreadPoolExecutor

        workers = min(len(fields), os.cpu_count() or 1)
        with ThreadPoolExecutor(workers,
                                thread_name_prefix="cbtpu_torch-encode") as ex:
            encoded = list(ex.map(one, fields))
    else:
        encoded = [one(f) for f in fields]
    columns = []
    blobs = []
    offset = len(MAGIC)
    for enc, blob in encoded:
        enc["offset"] = offset
        offset += len(blob)
        columns.append(enc)
        blobs.append(blob)

    footer = {
        "format": 1,
        "num_rows": n,
        "schema": [_field_json(f) for f in schema.fields],
        "columns": columns,
    }
    fbytes = json.dumps(footer).encode()
    body = bytearray(MAGIC)
    for b in blobs:
        body += b
    body += fbytes
    body += struct.pack("<I", len(fbytes))
    body += MAGIC
    if cipher is not None:
        # TDE: the WHOLE file encrypts — footers carry min/max stats and
        # string dictionaries, which are data, not just metadata
        body = MAGIC_ENC + cipher.encrypt(bytes(body))
    # the faulty-IO seam + the one durable write path: partition bytes
    # must be ON DISK before the manifest that references them commits
    # (fsync here; the commit fsyncs the manifest and CURRENT)
    fault_point("io_partition_write")
    iofault.durable_write(path, bytes(body))
    return footer


def _file_bytes(path: str, cipher) -> bytes:
    """Whole file, decrypted when TDE is on. Random access trades away:
    an encrypted file reads fully even for one column — the at-rest
    security boundary costs sequential IO, like the reference's TDE."""
    with open(path, "rb") as fh:
        head = fh.read(len(MAGIC_ENC))
        if head == MAGIC_ENC:
            if cipher is None:
                raise ValueError(
                    f"{path}: encrypted micro-partition but no "
                    "storage.encryption_key configured")
            return cipher.decrypt(fh.read())
        return head + fh.read()


def read_footer(path: str, cipher=None) -> dict:
    with open(path, "rb") as fh:
        head = fh.read(len(MAGIC_ENC))
        if head != MAGIC_ENC:
            # plaintext: seek to the trailer — footer-only pruning reads
            # must stay ~KB regardless of partition size
            if head[:len(MAGIC)] != MAGIC:
                raise ValueError(f"{path}: not a micro-partition file")
            fh.seek(-(len(MAGIC) + 4), 2)
            (flen,) = struct.unpack("<I", fh.read(4))
            tail = fh.read(len(MAGIC))
            if tail != MAGIC:
                raise ValueError(f"{path}: corrupt trailer")
            fh.seek(-(len(MAGIC) + 4 + flen), 2)
            return json.loads(fh.read(flen))
    # TDE: random access trades away — decrypt the whole file
    buf = _file_bytes(path, cipher)
    if buf[:len(MAGIC)] != MAGIC or buf[-len(MAGIC):] != MAGIC:
        raise ValueError(f"{path}: corrupt encrypted container")
    (flen,) = struct.unpack(
        "<I", buf[-(len(MAGIC) + 4):-len(MAGIC)])
    return json.loads(buf[-(len(MAGIC) + 4 + flen):-(len(MAGIC) + 4)])


def read_columns(path: str, names: Iterable[str] | None = None,
                 footer: dict | None = None,
                 cipher=None, pool=None,
                 on_decode=None, verify=False) -> dict[str, np.ndarray]:
    """Read (selected columns of) one micro-partition. ``pool``: a
    concurrent.futures-style executor for column-parallel decode (blob
    IO stays sequential — one file, one descriptor; the CPU work fans
    out). ``on_decode(seconds)`` reports each column's pure decode
    wall — the ``decode_seconds`` histogram feed. ``verify``: check
    each blob against its footer content checksum before decoding
    (TableStore.verify_checksums) — a mismatch raises
    ``StorageCorruptionError`` instead of decoding garbage."""
    with open(path, "rb") as fh:
        head = fh.read(len(MAGIC_ENC))
    if head == MAGIC_ENC:
        # TDE: sequential whole-file decrypt, then in-memory slicing
        buf = _file_bytes(path, cipher)

        def read_blob(enc):
            return buf[enc["offset"]:enc["offset"] + enc["length"]]

        if footer is None:
            (flen,) = struct.unpack(
                "<I", buf[-(len(MAGIC) + 4):-len(MAGIC)])
            footer = json.loads(
                buf[-(len(MAGIC) + 4 + flen):-(len(MAGIC) + 4)])
    else:
        # plaintext: seek-based column projection (no whole-file read)
        footer = footer or read_footer(path)
        fh = open(path, "rb")

        def read_blob(enc, fh=fh):
            fh.seek(enc["offset"])
            return fh.read(enc["length"])

    try:
        want = set(names) if names is not None else None
        schema = {c["name"]: c for c in footer["columns"]}
        types = {f["name"]: _field_from_json(f) for f in footer["schema"]}
        n = footer["num_rows"]
        sel = [(name, enc) for name, enc in schema.items()
               if want is None or name in want]
        # sequential blob reads (one descriptor), then fan the decode out
        blobs = {name: read_blob(enc) for name, enc in sel}

        if verify:
            st = os.stat(path)
            ident = (path, st.st_size, st.st_mtime_ns)

        def _one(name, enc):
            t0 = time.perf_counter()
            if verify and "cksum" in enc \
                    and (name,) + ident not in _verified:
                if not iofault.hash_matches(enc["cksum"], blobs[name]):
                    raise StorageCorruptionError(
                        f"{path}: column {name!r} failed its content "
                        f"checksum ({enc['cksum']}) — stored bytes are "
                        "corrupt; run `mgmt fsck`")
                if len(_verified) >= _VERIFIED_CAP:
                    _verified.clear()
                _verified[(name,) + ident] = True
            arr = decode_column(enc, blobs[name],
                                types[name].type.np_dtype, n)
            if on_decode is not None:
                on_decode(time.perf_counter() - t0)
            return arr

        if pool is not None and len(sel) > 1:
            futs = [(name, pool.submit(_one, name, enc))
                    for name, enc in sel]
            return {name: f.result() for name, f in futs}
        return {name: _one(name, enc) for name, enc in sel}
    finally:
        if head != MAGIC_ENC:
            fh.close()


def verify_file(path: str, cipher=None) -> list[str]:
    """Offline integrity check of one micro-partition (the fsck deep
    pass): container framing parses and every column blob matches its
    footer checksum. Returns problem descriptions (empty = clean);
    never raises for corruption — fsck wants the list, not the first
    failure."""
    problems = []
    try:
        footer = read_footer(path, cipher=cipher)
    except Exception as e:  # noqa: BLE001 — any parse failure IS the finding
        return [f"{path}: unreadable container/footer: {e}"]
    try:
        with open(path, "rb") as fh:
            head = fh.read(len(MAGIC_ENC))
        if head == MAGIC_ENC:
            buf = _file_bytes(path, cipher)

            def read_blob(enc):
                return buf[enc["offset"]:enc["offset"] + enc["length"]]
        else:
            fh = open(path, "rb")

            def read_blob(enc, fh=fh):
                fh.seek(enc["offset"])
                return fh.read(enc["length"])
        try:
            for enc in footer["columns"]:
                if "cksum" not in enc:
                    continue  # pre-checksum file: nothing to verify
                blob = read_blob(enc)
                if len(blob) != enc["length"]:
                    problems.append(
                        f"{path}: column {enc['name']!r} truncated "
                        f"({len(blob)} of {enc['length']} bytes)")
                    continue
                verdict = iofault.hash_verdict(enc["cksum"], blob)
                if verdict == "mismatch":
                    problems.append(
                        f"{path}: column {enc['name']!r} failed its "
                        f"content checksum ({enc['cksum']})")
                elif verdict == "unknown":
                    # a corrupted algorithm label must not read as clean
                    # offline; the hot path alone stays lenient for
                    # forward-compat footers
                    problems.append(
                        f"{path}: column {enc['name']!r} carries an "
                        f"unknown checksum algorithm ({enc['cksum']!r}) "
                        "— cannot verify")
        finally:
            if head != MAGIC_ENC:
                fh.close()
    except Exception as e:  # noqa: BLE001
        problems.append(f"{path}: unreadable column data: {e}")
    return problems


_BLOOM_BITS = 2048
_BLOOM_K = 3


def _bloom_hashes(vals: np.ndarray) -> list[np.ndarray]:
    """k bit positions per value via two mixed 64-bit hashes (Kirsch-
    Mitzenmacher double hashing)."""
    x = vals.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    h2 = x * np.uint64(0xC4CEB9FE1A85EC53) ^ (x >> np.uint64(29))
    m = np.uint64(_BLOOM_BITS)
    return [((x + np.uint64(i) * h2) % m).astype(np.int64)
            for i in range(_BLOOM_K)]


def _bloom_build(arr: np.ndarray) -> str:
    import base64

    bits = np.zeros(_BLOOM_BITS, dtype=bool)
    for pos in _bloom_hashes(arr):
        bits[pos] = True
    return base64.b64encode(np.packbits(bits).tobytes()).decode()


def bloom_may_contain(enc: dict, value) -> bool:
    """False means the partition provably lacks ``value`` in this column."""
    b64 = enc.get("bloom")
    if b64 is None:
        return True
    import base64

    bits = np.unpackbits(
        np.frombuffer(base64.b64decode(b64), dtype=np.uint8))
    for pos in _bloom_hashes(np.asarray([value], dtype=np.int64)):
        if not bits[int(pos[0])]:
            return False
    return True


def prune_by_stats(footer: dict, column: str, lo=None, hi=None) -> bool:
    """True if the partition MAY contain rows with column in [lo, hi] —
    False means provably disjoint and the file can be skipped (the
    min/max sparse-filter move of PAX micro_partition_stats.cc)."""
    enc = next((c for c in footer["columns"] if c["name"] == column), None)
    if enc is None or "min" not in enc:
        return True
    if lo is not None and enc["max"] < lo:
        return False
    if hi is not None and enc["min"] > hi:
        return False
    return True


def _field_json(f: Field) -> dict:
    return {"name": f.name, "base": f.type.base.value, "scale": f.type.scale}


def _field_from_json(j: dict) -> Field:
    return Field(j["name"], SqlType(DType(j["base"]), j.get("scale", 0)))


def _json_num(v):
    v = v.item() if hasattr(v, "item") else v
    return v
