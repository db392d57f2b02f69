"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

The JAX package has three Pallas kernels (exec/pallas_kernels.py); each has
a counterpart here, written in CUDA C++ under ``cloudberry_tpu_torch/csrc``:

============  ===========================  =================================
kernel        replaces                     source
============  ===========================  =================================
dense_agg     dense_agg_tiles_pallas       csrc/dense_agg.cu
probe_join    probe_join_pallas            csrc/probe_join.cu
sorted_seg    sorted_seg_pallas            csrc/sorted_seg.cu
============  ===========================  =================================

Each source's header says what bounds the kernel on an H100 and what its
design does about it. The sources build at first use, with one ``nvcc`` per
source started together, into shared libraries with a plain C interface
under ``cloudberry_tpu_torch/build/`` (git-ignored), loaded with ctypes.

Every wrapper has a plain PyTorch version beside it. A wrapper takes the
plain version only for tensors that lie on the CPU (the tests); for CUDA
tensors it launches its kernel or raises — there is no fallback and no
switch. ``LAUNCHES`` counts kernel launches per kernel name; only a launch
adds to it.

Threads: the serving layer launches from worker threads torch never
initialised. The one-time build and load run under ``_BUILD_LOCK`` (one
nvcc per source per process, never two writers of one library file), the
launch counters under ``_COUNT_LOCK``. A kernel goes to the calling
thread's current stream (``_stream``): the default stream in every
thread that never set one, the stream PyTorch's own operators and result
copies of that thread use, so no launch races a copy of another thread.
``sorted_seg`` picks its header set and launches under ``_SEG_LOCK``: the
alternation between its two sets holds only if the calls reach a stream
in the order they picked their sets.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path

import torch

from cloudberry_tpu_torch.exec import kernels as K

LAUNCHES: dict[str, int] = {"dense_agg": 0, "probe_join": 0, "sorted_seg": 0}

SOURCES = {name: f"{name}.cu" for name in LAUNCHES}
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# the reference's gates, kept so the port takes the same path per plan
PROBE_MAX_BUILD = 2048
# the probe-join kernel's argument block (probe_join.cu kMaxKeys,
# kMaxPayload); a join with more columns keeps the sorted lookup
PROBE_MAX_KEYS = 4
PROBE_MAX_PAYLOAD = 16
MAX_SEG_ROWS = 1 << 23

# the H100's shared memory a block may opt into (dense_agg.cu kSmemMax)
SMEM_MAX = 232_448
# dense_agg modes, in the order of cb_dense_agg's `mode` argument
DENSE_MODES = ("private4", "private16", "shared", "global")
# sorted_seg: a lane sums a group of at most SEG_SHORT_ROWS rows; longer
# groups are cut into chunks of SEG_CHUNK_ROWS rows dealt out over the grid
# (sorted_seg.cu's header note says why)
SEG_SHORT_ROWS = 32
SEG_CHUNK_ROWS = 1 << 10
SEG_CHUNK_BLOCKS = 2    # chunk-pass blocks an SM, resident beside seg_main
SEG_MAX_CAP = 1 << 27   # the queue's entry count field (sorted_seg.cu)

_P = ctypes.c_void_p
_I, _I64 = ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "dense_agg": ("cb_dense_agg",
                  [_P, _P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _P, _P,
                   _P]),
    "probe_join": ("cb_probe_join", [ctypes.c_char_p, _P]),
    "sorted_seg": ("cb_sorted_seg",
                   [_P, _I, _I64, _P, _P, _P, _I64, _I64, _I64, _P, _P, _P,
                    _P, _I64, _I, _P]),
}

_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_SEG_LOCK = threading.Lock()
# nvcc runs that built a library in this process (a library already on
# disk under its source hash loads without one)
NVCC_BUILDS = 0


class KernelBuildError(RuntimeError):
    """A kernel library could not be built (no nvcc, or a compiler error).
    Never a reason to re-dispatch a statement (parallel/health.py)."""


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels in cloudberry_tpu_torch/csrc")


def _lib_path(name: str) -> Path:
    """The library's file name carries a hash of its source, the shared
    headers and the flags, so an edit never loads a stale build."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    tag = h.hexdigest()[:12]
    return BUILD / f"lib{name}-{tag}.so"


def loaded() -> bool:
    """True once every kernel library is loaded in this process."""
    return all(n in _LIBS for n in SOURCES)


def build(verbose: bool = False) -> dict[str, ctypes.CDLL]:
    """Compile every kernel source not yet built (one nvcc each, all in
    parallel) and load the libraries. Raises on any compiler error.
    Thread-safe: a second thread waits for the first's build."""
    if loaded():
        return _LIBS
    with _BUILD_LOCK:
        return _build_locked(verbose)


def _build_locked(verbose: bool) -> dict[str, ctypes.CDLL]:
    missing = [n for n in SOURCES if n not in _LIBS]
    if not missing:
        return _LIBS
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    global NVCC_BUILDS
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {SOURCES[name]} failed:\n{log}")
            continue
        NVCC_BUILDS += 1
        if verbose:
            print(f"[build] {SOURCES[name]}:\n{log.strip()}")
        os.replace(tmp, out)
    if errors:
        raise KernelBuildError("\n".join(errors))
    for name in missing:
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS


def _launch(name: str, *args) -> None:
    fn = getattr(build()[name], _SIGNATURES[name][0])
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; anything else (mixed
    devices, other backends) is refused."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs on unsupported devices {kinds}")


def _check(t: torch.Tensor, dtype: torch.dtype, what: str) -> torch.Tensor:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    return t.contiguous()


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------- dense_agg


def dense_agg(gid: torch.Tensor, ivals: torch.Tensor, fvals: torch.Tensor,
              sel: torch.Tensor, n_cells: int):
    """Grouped COUNT + SUM over cells [0, n_cells): gid int32[N],
    ivals int64[Ki, N], fvals float64[Kf, N], sel bool[N]. Rows that are
    unselected or whose gid is outside the domain add nothing. Returns
    (counts int64[cells], isums int64[Ki, cells], fsums float64[Kf, cells]);
    integer sums wrap mod 2^64 like int64 adds."""
    gid = _check(gid, torch.int32, "dense_agg gid")
    ivals = _check(ivals, torch.int64, "dense_agg ivals")
    fvals = _check(fvals, torch.float64, "dense_agg fvals")
    sel = _check(sel, torch.bool, "dense_agg sel")
    n = gid.shape[0]
    if ivals.shape[1:] != (n,) or fvals.shape[1:] != (n,) or \
            sel.shape != (n,):
        raise ValueError(f"dense_agg: shapes {tuple(gid.shape)}, "
                         f"{tuple(ivals.shape)}, {tuple(fvals.shape)}, "
                         f"{tuple(sel.shape)} do not agree")
    if not _on_cuda(gid, ivals, fvals, sel):
        return dense_agg_plain(gid, ivals, fvals, sel, n_cells)
    ki, kf = ivals.shape[0], fvals.shape[0]
    mode, threads, smem = dense_agg_plan(ki, kf, n_cells)
    # accumulation targets start at zero (the kernel adds into them)
    out_int = torch.zeros((1 + ki, n_cells), dtype=torch.int64,
                          device=gid.device)
    out_flt = torch.zeros((kf, n_cells), dtype=torch.float64,
                          device=gid.device)
    _launch("dense_agg", gid.data_ptr(), ivals.data_ptr(), fvals.data_ptr(),
            sel.data_ptr(), n, ki, kf, n_cells, DENSE_MODES.index(mode),
            threads, smem, out_int.data_ptr(), out_flt.data_ptr(),
            _stream(gid))
    return out_int[0], out_int[1:], out_flt


def dense_agg_plan(ki: int, kf: int, n_cells: int) -> tuple[str, int, int]:
    """(mode, threads a block, dynamic shared bytes) of the dense_agg
    kernel for Ki int and Kf float value rows over n_cells cells.

    "private4"/"private16" give every thread its own column of
    (1 + Ki + Kf) * cells 8-byte accumulators, at 256 threads a block or as
    few as 64, and take 4 rows a step (16 when there are at most two value
    rows, to keep as many bytes in flight); "shared" gives the block one
    copy of them, added with shared-memory atomics; "global" adds into the
    output with global atomics."""
    slots = (1 + ki + kf) * n_cells
    for threads in (256, 128, 64):
        if threads * slots * 8 <= SMEM_MAX:
            mode = "private16" if ki + kf <= 2 else "private4"
            return mode, threads, threads * slots * 8
    if slots * 8 <= SMEM_MAX:
        return "shared", 256, slots * 8
    return "global", 256, 0


def dense_agg_plain(gid, ivals, fvals, sel, n_cells: int):
    """The plain version: one index_add_ per output into a spare cell for
    dropped rows."""
    keep = sel & (gid >= 0) & (gid < n_cells)
    g = torch.where(keep, gid, torch.full_like(gid, n_cells)).to(torch.int64)
    dev = gid.device

    def seg(v, dtype):  # v: [K, N] -> [K, cells]
        out = torch.zeros((n_cells + 1, v.shape[0]), dtype=dtype, device=dev)
        return out.index_add_(0, g, v.t())[:n_cells].t().contiguous()

    counts = seg(keep.to(torch.int64)[None], torch.int64)[0]
    return counts, seg(ivals, torch.int64), seg(fvals, torch.float64)


# -------------------------------------------------------------- probe_join

# the argument block of cb_probe_join (probe_join.cu ProbeJoinArgs): key,
# payload and output pointers, bsel, psel, matched, dup, n, b, the key and
# payload counts, the key column types and the payload widths
_PROBE_ARGS = struct.Struct(
    f"<{2 * PROBE_MAX_KEYS + 2 * PROBE_MAX_PAYLOAD + 4}Qq3i"
    f"{2 * PROBE_MAX_KEYS + PROBE_MAX_PAYLOAD}b4x")
# probe_join.cu's key column types
_KEY_TYPES = {torch.bool: 0, torch.int32: 1, torch.int64: 2}


def _probe_key(k: torch.Tensor, n: int, what: str) -> torch.Tensor:
    """A key column as the kernel reads it: bool, int32 and int64 as they
    are, any other dtype as its sort_key_u64 (one op)."""
    if k.shape != (n,):
        raise ValueError(f"probe_join: {what} key of shape "
                         f"{tuple(k.shape)}, expected ({n},)")
    if k.dtype not in _KEY_TYPES:
        k = K.sort_key_u64(k)
    return k.contiguous()


def probe_join(bkeys, bsel: torch.Tensor, pkeys, psel: torch.Tensor,
               payload, dup: torch.Tensor):
    """The probe-join operator against a small build, from the raw key
    columns: bkeys/pkeys are lists of 1 to PROBE_MAX_KEYS key columns
    ([B ≤ 2048] and [N], any dtype), packed as the reference packs them
    (key_ranges over the selected build rows, pack_with_ranges, downcast32)
    and compared as u32; payload is a list of at most PROBE_MAX_PAYLOAD
    non-float columns [B]. Returns (matched bool[N], the payload columns
    gathered to probe rows in their own dtypes: the lowest-index matching
    selected build row's value, 0 where unmatched). A selected probe row
    that hits two or more selected build rows sets dup (int32[1], the
    caller's zeroed slot) to 1; dup is never cleared."""
    b, n = bsel.shape[0], psel.shape[0]
    if b > PROBE_MAX_BUILD:
        raise ValueError(f"probe_join: build of {b} rows exceeds "
                         f"{PROBE_MAX_BUILD}")
    if not 1 <= len(bkeys) == len(pkeys) <= PROBE_MAX_KEYS or \
            len(payload) > PROBE_MAX_PAYLOAD:
        raise ValueError(f"probe_join: {len(bkeys)}/{len(pkeys)} key and "
                         f"{len(payload)} payload columns (at most "
                         f"{PROBE_MAX_KEYS} and {PROBE_MAX_PAYLOAD})")
    bsel = _check(bsel, torch.bool, "probe_join bsel")
    psel = _check(psel, torch.bool, "probe_join psel")
    dup = _check(dup, torch.int32, "probe_join dup")
    if bsel.dim() != 1 or psel.dim() != 1 or dup.shape != (1,):
        raise ValueError("probe_join: selections must be vectors and dup "
                         "one int32")
    bkeys = [_probe_key(k, b, "build") for k in bkeys]
    pkeys = [_probe_key(k, n, "probe") for k in pkeys]
    for c in payload:
        if c.shape != (b,) or c.dtype.is_floating_point or \
                c.dtype.is_complex:
            raise TypeError(f"probe_join: payload column {c.dtype} "
                            f"{tuple(c.shape)} is not an integer or bool "
                            f"column of {b} rows")
    payload = [c.contiguous() for c in payload]
    if not _on_cuda(bsel, psel, dup, *bkeys, *pkeys, *payload):
        return probe_join_plain(bkeys, bsel, pkeys, psel, payload, dup)
    dev = psel.device
    matched = torch.empty((n,), dtype=torch.bool, device=dev)
    out = [torch.empty((n,), dtype=c.dtype, device=dev) for c in payload]
    nk, np_ = len(bkeys), len(payload)
    zk, zp = [0] * (PROBE_MAX_KEYS - nk), [0] * (PROBE_MAX_PAYLOAD - np_)
    block = _PROBE_ARGS.pack(
        *[k.data_ptr() for k in bkeys], *zk,
        *[k.data_ptr() for k in pkeys], *zk,
        *[c.data_ptr() for c in payload], *zp,
        *[c.data_ptr() for c in out], *zp,
        bsel.data_ptr(), psel.data_ptr(), matched.data_ptr(),
        dup.data_ptr(), n, b, nk, np_,
        *[_KEY_TYPES[k.dtype] for k in bkeys], *zk,
        *[_KEY_TYPES[k.dtype] for k in pkeys], *zk,
        *[c.element_size() for c in payload], *zp)
    _launch("probe_join", block, _stream(psel))
    return matched, out


def probe_join_plain(bkeys, bsel, pkeys, psel, payload, dup):
    """The plain version: the port's key_ranges, pack_with_ranges and
    downcast32, then sort the selected build keys, binary-search each
    probe key and count matches from the equal range."""
    ranges = K.key_ranges(bkeys, bsel)
    bp = K.downcast32(K.pack_with_ranges(bkeys, ranges))
    pp = K.downcast32(K.pack_with_ranges(pkeys, ranges))
    bidx = torch.nonzero(bsel).flatten()
    keys = bp[bidx].to(torch.int64)
    order = torch.sort(keys, stable=True).indices
    sk, src = keys[order], bidx[order]
    pk = pp.to(torch.int64)
    lo = torch.searchsorted(sk, pk, right=False)
    hi = torch.searchsorted(sk, pk, right=True)
    cnt = torch.where(psel, hi - lo, torch.zeros_like(lo))
    matched = cnt > 0
    if sk.shape[0]:
        first = src[lo.clamp(max=sk.shape[0] - 1)]
        out = [torch.where(matched, c[first], K._full(c, 0))
               for c in payload]
    else:
        out = [torch.zeros_like(pk, dtype=c.dtype) for c in payload]
    dup.bitwise_or_((cnt > 1).any().to(torch.int32))
    return matched, out


# -------------------------------------------------------------- sorted_seg


def sorted_seg(vals: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
               n_groups: torch.Tensor, cap: int):
    """Segmented SUM over group-sorted rows: vals int64[R, N] (zero on
    unselected rows), starts/ends int64[cap] inclusive row ranges, valid
    below the device scalar n_groups. Returns (counts int64[cap],
    sums int64[R, cap]), zero past n_groups; sums wrap like int64 adds."""
    vals = _check(vals, torch.int64, "sorted_seg vals")
    starts = _check(starts, torch.int64, "sorted_seg starts")
    ends = _check(ends, torch.int64, "sorted_seg ends")
    n_groups = _check(n_groups.reshape(1), torch.int64, "sorted_seg n_groups")
    if vals.dim() != 2 or starts.shape != (cap,) or ends.shape != (cap,):
        raise ValueError(f"sorted_seg: vals {tuple(vals.shape)}, starts "
                         f"{tuple(starts.shape)}, ends {tuple(ends.shape)} "
                         f"for {cap} slots")
    if not _on_cuda(vals, starts, ends, n_groups):
        return sorted_seg_plain(vals, starts, ends, n_groups[0], cap)
    r, n = vals.shape
    if cap >= SEG_MAX_CAP:
        raise ValueError(f"sorted_seg: {cap} slots exceed {SEG_MAX_CAP - 1}")
    dev = vals.device
    short_rows, chunk_rows, queue_cap, chunk_blocks = sorted_seg_plan(n, cap)
    out = torch.empty((1 + r, cap), dtype=torch.int64, device=dev)
    entries = torch.empty((2 * queue_cap,), dtype=torch.int64, device=dev)
    stream = _stream(vals)
    with _SEG_LOCK:
        header, spare = _seg_headers(dev, stream)
        try:
            _launch("sorted_seg", vals.data_ptr(), r, n, starts.data_ptr(),
                    ends.data_ptr(), n_groups.data_ptr(), cap, short_rows,
                    chunk_rows, out.data_ptr(), header.data_ptr(),
                    spare.data_ptr(), entries.data_ptr(), queue_cap,
                    chunk_blocks, stream)
        except RuntimeError:
            # a set may be left dirty
            del _SEG_HEADERS[(dev.index, stream)]
            raise
    return out[0], out[1:]


def sorted_seg_plan(n_rows: int, cap: int) -> tuple[int, int, int, int]:
    """(short_rows, chunk_rows, queue_cap, chunk_blocks_per_sm) of the
    sorted_seg kernel over n_rows input rows and cap output slots. Groups
    longer than short_rows rows are queued for the chunk pass; disjoint row
    ranges hold at most n_rows // (short_rows + 1) of them and there are at
    most cap groups, so the queue never overflows on group_layout's
    boundaries."""
    return (SEG_SHORT_ROWS, SEG_CHUNK_ROWS,
            min(cap, n_rows // (SEG_SHORT_ROWS + 1)) + 1, SEG_CHUNK_BLOCKS)


# per (device, stream): two header sets and the number of calls so far
_SEG_HEADERS: dict[tuple[int, int], list] = {}


def _seg_headers(dev: torch.device, stream: int):
    """The sorted_seg kernel's header words (queue, padding chunks taken)
    for this call, and the spare set it zeroes for the next call. The two
    sets alternate, so no call pays a memset (sorted_seg.cu)."""
    key = (dev.index, stream)
    if key not in _SEG_HEADERS:
        _SEG_HEADERS[key] = [torch.zeros((2, 2), dtype=torch.int64,
                                         device=dev), 0]
    state = _SEG_HEADERS[key]
    sets, calls = state
    state[1] = calls + 1
    return sets[calls % 2], sets[(calls + 1) % 2]


def sorted_seg_plain(vals, starts, ends, n_groups, cap: int):
    """The plain version: cumulative-sum differences between group
    boundaries (the reference's sort-path formulation)."""
    valid = torch.arange(cap, device=vals.device) < n_groups
    c0 = torch.cat([torch.zeros((vals.shape[0], 1), dtype=torch.int64,
                                device=vals.device),
                    torch.cumsum(vals, 1)], dim=1)
    zero = torch.zeros((), dtype=torch.int64, device=vals.device)
    sums = torch.where(valid, c0[:, ends + 1] - c0[:, starts], zero)
    counts = torch.where(valid, ends - starts + 1, zero)
    return counts, sums


def sorted_segment_eligible(aggs, agg_values, n_rows: int) -> bool:
    """The reference's gate for the sorted-segment path: SUM/AVG over
    integer-carried values (BIGINT, DECIMAL cents, INT) plus COUNT, at most
    MAX_SEG_ROWS input rows. MIN/MAX, BOOL and float sums keep the sort
    path."""
    if n_rows > MAX_SEG_ROWS:
        return False
    for spec in aggs:
        if spec.func == "count":
            continue
        if spec.func not in ("sum", "avg"):
            return False
        v = agg_values.get(spec.out_name)
        if v is None or not K._is_int(v):
            return False
    return True


def sorted_segment_aggregate(key_cols, agg_values, aggs, sel,
                             out_capacity: int):
    """Drop-in for kernels.group_aggregate on an eligible agg: the same
    group_layout sort and boundaries, the sums from the sorted_seg kernel.

    Returns (out_key_cols, out_agg_cols, out_sel, n_groups) with the sort
    path's exact contract: groups in ascending key order, int sums
    bit-identical, avg the same f64 division of the same exact ints."""
    lay = K.group_layout(key_cols, sel, out_capacity)
    rows, layout = [], []  # layout: (spec, row, value dtype)
    for spec in aggs:
        if spec.func == "count":
            continue
        v = agg_values[spec.out_name][lay.perm]
        v = torch.where(lay.s_sel, v, torch.zeros_like(v))
        layout.append((spec, len(rows), v.dtype))
        rows.append(v.to(torch.int64))
    vals = torch.stack(rows) if rows else \
        torch.zeros((0, sel.shape[0]), dtype=torch.int64, device=sel.device)
    counts, sums = sorted_seg(vals, lay.starts, lay.ends, lay.n_groups,
                              out_capacity)
    out_aggs = {}
    for spec, row, dt in layout:
        if spec.func == "avg":
            out_aggs[spec.out_name] = sums[row].to(torch.float64) \
                / counts.clamp_min(1)
        else:
            out_aggs[spec.out_name] = sums[row].to(dt)
    for spec in aggs:
        if spec.func == "count":
            out_aggs[spec.out_name] = counts
    out_sel = torch.arange(out_capacity, device=sel.device) < lay.n_groups
    return lay.out_keys, out_aggs, out_sel, lay.n_groups
