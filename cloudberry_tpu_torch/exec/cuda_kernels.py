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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
    "probe_join": ("cb_probe_join",
                   [_P, _P, _I, _P, _P, _I64, _P, _I, _P, _P, _P, _P]),
    "sorted_seg": ("cb_sorted_seg",
                   [_P, _I, _I64, _P, _P, _P, _I64, _I64, _I64, _P, _P, _P,
                    _P, _I64, _I, _P]),
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in cloudberry_tpu_torch/csrc")


def _lib_path(name: str) -> Path:
    """The library's file name carries a hash of its source, the shared
    headers and the flags, so an edit never loads a stale build."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    tag = h.hexdigest()[:12]
    return BUILD / f"lib{name}-{tag}.so"


def build(verbose: bool = False) -> dict[str, ctypes.CDLL]:
    """Compile every kernel source not yet built (one nvcc each, all in
    parallel) and load the libraries. Raises on any compiler error."""
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
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {SOURCES[name]} failed:\n{log}")
            continue
        if verbose:
            print(f"[build] {SOURCES[name]}:\n{log.strip()}")
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
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


def probe_join(bkeys: torch.Tensor, bsel: torch.Tensor, pkeys: torch.Tensor,
               psel: torch.Tensor, payload: torch.Tensor):
    """Probe join against a small build: bkeys int32[B ≤ 2048] and pkeys
    int32[N] are packed u32 keys (compared for equality only), payload
    int64[P, B]. Returns (matched bool[N], gathered int64[P, N] — the first
    matching selected build row's payload, 0 where unmatched, has_dup bool
    scalar — a selected probe row hit two or more selected build rows)."""
    bkeys = _check(bkeys, torch.int32, "probe_join bkeys")
    bsel = _check(bsel, torch.bool, "probe_join bsel")
    pkeys = _check(pkeys, torch.int32, "probe_join pkeys")
    psel = _check(psel, torch.bool, "probe_join psel")
    payload = _check(payload, torch.int64, "probe_join payload")
    b, n, p = bkeys.shape[0], pkeys.shape[0], payload.shape[0]
    if b > PROBE_MAX_BUILD:
        raise ValueError(f"probe_join: build of {b} rows exceeds "
                         f"{PROBE_MAX_BUILD}")
    if not _on_cuda(bkeys, bsel, pkeys, psel, payload):
        return probe_join_plain(bkeys, bsel, pkeys, psel, payload)
    dev = pkeys.device
    matched = torch.empty((n,), dtype=torch.bool, device=dev)
    out = torch.empty((p, n), dtype=torch.int64, device=dev)
    has_dup = torch.zeros((1,), dtype=torch.int32, device=dev)
    _launch("probe_join", bkeys.data_ptr(), bsel.data_ptr(), b,
            pkeys.data_ptr(), psel.data_ptr(), n, payload.data_ptr(), p,
            matched.data_ptr(), out.data_ptr(), has_dup.data_ptr(),
            _stream(pkeys))
    return matched, out, has_dup[0] != 0


def probe_join_plain(bkeys, bsel, pkeys, psel, payload):
    """The plain version: sort the selected build keys, binary-search
    each probe key, count matches from the equal range."""
    bidx = torch.nonzero(bsel).flatten()
    keys = bkeys[bidx].to(torch.int64)
    order = torch.sort(keys, stable=True).indices
    sk, src = keys[order], bidx[order]
    pk = pkeys.to(torch.int64)
    lo = torch.searchsorted(sk, pk, right=False)
    hi = torch.searchsorted(sk, pk, right=True)
    cnt = torch.where(psel, hi - lo, torch.zeros_like(lo))
    matched = cnt > 0
    if sk.shape[0] == 0:
        out = torch.zeros((payload.shape[0], pk.shape[0]),
                          dtype=torch.int64, device=pk.device)
    else:
        first = src[lo.clamp(max=sk.shape[0] - 1)]
        out = torch.where(matched, payload[:, first],
                          torch.zeros((), dtype=torch.int64,
                                      device=pk.device))
    return matched, out, (cnt > 1).any()


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
    header, spare = _seg_headers(dev, stream)
    try:
        _launch("sorted_seg", vals.data_ptr(), r, n, starts.data_ptr(),
                ends.data_ptr(), n_groups.data_ptr(), cap, short_rows,
                chunk_rows, out.data_ptr(), header.data_ptr(),
                spare.data_ptr(), entries.data_ptr(), queue_cap,
                chunk_blocks, stream)
    except RuntimeError:
        del _SEG_HEADERS[(dev.index, stream)]  # a set may be left dirty
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
