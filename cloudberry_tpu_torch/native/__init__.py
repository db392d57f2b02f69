"""Native codec bindings (ctypes; builds native/codec.cpp on demand).

The compute path is PyTorch and CUDA; the runtime byte-work around it —
storage codecs, ingest parsing — is native C++ like the reference's
(cdbappendonlystorageformat.c, contrib/pax_storage), with bit-identical
numpy fallbacks so every environment works and tests can diff the two.
The source is this package's own copy (``codec.cpp`` beside this file);
``g++`` builds it at first use into the package's git-ignored
``build/`` directory, where the CUDA kernels build too.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_lib = None
_tried = False
# the first call builds and loads; callers on other threads (a parallel
# write's column encoders, the scan pipeline's decoders) wait for it
_load_lock = threading.Lock()


_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "codec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")


def load_native():
    """Build (once) and load libcbcodec; None if no toolchain."""
    if _lib is not None or _tried:
        return _lib
    with _load_lock:
        return _load_locked()


def _load_locked():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    src = SOURCE
    if not os.path.exists(src):
        return None
    try:
        build_dir = BUILD_DIR
        os.makedirs(build_dir, exist_ok=True)
        so = os.path.join(build_dir, "libcbcodec.so")
        if not os.path.exists(so) or \
                os.path.getmtime(so) < os.path.getmtime(src):
            tmp = tempfile.mktemp(suffix=".so", dir=build_dir)
            subprocess.run(
                ["g++", "-O3", "-fwrapv", "-shared", "-fPIC", src, "-o", tmp],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
    except Exception:
        return None  # read-only fs / no toolchain → numpy fallback
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.cb_dvarint_encode.restype = ctypes.c_int64
    lib.cb_dvarint_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.cb_dvarint_decode.restype = ctypes.c_int64
    lib.cb_dvarint_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.cb_parse_int64_column.restype = ctypes.c_int64
    lib.cb_parse_int64_column.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int64]
    lib.cb_jump_hash.restype = None
    lib.cb_jump_hash.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.cb_parse_decimal_column.restype = ctypes.c_int64
    lib.cb_parse_decimal_column.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64]
    _lib = lib
    return _lib


# ---------------------------------------------------------- placement hash


def jump_hash(keys: np.ndarray, n_buckets: int):
    """``utils/hashing.jump_consistent_hash_np`` in C (int32 bucket per
    uint64 key, bit-identical); None without the native library."""
    lib = load_native()
    if lib is None:
        return None
    k = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(k.shape, dtype=np.int32)
    lib.cb_jump_hash(k.ctypes.data, k.size, int(n_buckets), out.ctypes.data)
    return out


# ----------------------------------------------------------------- varint


def dvarint_encode(arr: np.ndarray) -> bytes:
    """int64 column → delta+zigzag+LEB128 bytes (native or numpy fallback,
    bit-identical)."""
    arr = np.ascontiguousarray(arr, dtype=np.int64)
    lib = load_native()
    if lib is not None:
        out = np.empty(arr.size * 10, dtype=np.uint8)
        n = lib.cb_dvarint_encode(arr.ctypes.data, arr.size, out.ctypes.data)
        return out[:n].tobytes()
    return _dvarint_encode_np(arr)


def dvarint_decode(buf: bytes, n: int) -> np.ndarray:
    lib = load_native()
    if lib is not None:
        src = np.frombuffer(buf, dtype=np.uint8)
        out = np.empty(n, dtype=np.int64)
        used = lib.cb_dvarint_decode(src.ctypes.data if src.size else 0,
                                     src.size, n, out.ctypes.data)
        if used < 0:
            raise ValueError("corrupt dvarint stream")
        return out
    return _dvarint_decode_np(buf, n)


def _dvarint_encode_np(arr: np.ndarray) -> bytes:
    deltas = np.diff(arr, prepend=np.int64(0)).astype(np.int64)
    z = (deltas.astype(np.uint64) << np.uint64(1)) ^ \
        (deltas >> np.int64(63)).astype(np.uint64)
    out = bytearray()
    for v in z.tolist():
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)
    return bytes(out)


def _dvarint_decode_np(buf: bytes, n: int) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    prev = 0
    i = 0
    pos = 0
    L = len(buf)
    while i < n:
        z = 0
        shift = 0
        while True:
            if pos >= L:
                raise ValueError("corrupt dvarint stream")
            b = buf[pos]
            pos += 1
            z |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 63:
                raise ValueError("corrupt dvarint stream")
        d = (z >> 1) ^ -(z & 1)
        prev = (prev + d) & 0xFFFFFFFFFFFFFFFF
        if prev >= 1 << 63:
            out[i] = prev - (1 << 64)
        else:
            out[i] = prev
        i += 1
    return out


# -------------------------------------------------------------- CSV ingest


def parse_int64_column(buf: bytes, col_index: int, delim: str = "|",
                       max_rows: int | None = None) -> np.ndarray:
    """Fast single-column int64 extraction from a delimited file buffer
    (the gpfdist-style parallel loader's inner loop)."""
    max_rows = max_rows if max_rows is not None else buf.count(b"\n") + 1
    lib = load_native()
    if lib is not None:
        out = np.empty(max_rows, dtype=np.int64)
        n = lib.cb_parse_int64_column(buf, len(buf), delim.encode()[0:1],
                                      col_index, out.ctypes.data, max_rows)
        if n < 0:
            raise ValueError(f"malformed integer in column {col_index}")
        return out[:n]
    out = []
    d = delim.encode()
    for ln in buf.splitlines():
        if len(out) >= max_rows:
            break
        parts = ln.split(d)
        if not ln or len(parts) <= col_index:
            continue  # short line: skipped, matching the native parser
        out.append(int(parts[col_index]))
    return np.asarray(out, dtype=np.int64)


def parse_decimal_column(buf: bytes, col_index: int, scale: int = 2,
                         delim: str = "|",
                         max_rows: int | None = None) -> np.ndarray:
    """Decimal column → int64 fixed-point at the given scale."""
    max_rows = max_rows if max_rows is not None else buf.count(b"\n") + 1
    lib = load_native()
    if lib is not None:
        out = np.empty(max_rows, dtype=np.int64)
        n = lib.cb_parse_decimal_column(buf, len(buf), delim.encode()[0:1],
                                        col_index, scale, out.ctypes.data,
                                        max_rows)
        if n < 0:
            raise ValueError(f"malformed decimal in column {col_index}")
        return out[:n]
    pow10 = 10 ** scale
    vals = []
    d = delim.encode()
    for ln in buf.splitlines():
        if len(vals) >= max_rows:
            break
        parts = ln.split(d)
        if not ln or len(parts) <= col_index:
            continue
        # integer-exact parse (no float round-trip), matching the native path
        f = parts[col_index].decode()
        neg = f.startswith("-")
        if neg:
            f = f[1:]
        whole, _, frac = f.partition(".")
        frac = (frac + "0" * scale)[:scale]
        v = int(whole or "0") * pow10 + (int(frac) if frac else 0)
        vals.append(-v if neg else v)
    return np.asarray(vals, dtype=np.int64)
