"""The traced run: torch.profiler over the window, the program's own
statement spans and counters, and the launch shapes of the three CUDA
kernels, recorded by wrappers that this file installs around the
program's kernel entry points for the window only.

Times are host ``perf_counter`` seconds. The profiler's device clock is
tied to it by one marker kernel launched right after a synchronize.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

from cbbench.metrics import _roofline

KERNELS = ("dense_agg", "sorted_seg", "probe_join")
# the profiler's kernel names of each kernel (csrc/*.cu)
KERNEL_NAMES = {"dense_agg": ("dense_agg_private", "dense_agg_shared",
                              "dense_agg_global"),
                "sorted_seg": ("seg_main", "seg_chunks"),
                "probe_join": ("probe_join_kernel",)}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, session, on_card: bool):
        self.session = session
        self.on_card = on_card
        self.launches: dict[str, list] = {k: [] for k in KERNELS}
        self.spans: list[dict] = []
        self.counters: dict[str, int] = {}
        self.device_ops: list[tuple[float, float, str]] = []
        self.busy_s = None
        self.window_s = None
        self.t_start = self.t_stop = 0.0
        self._prof = None
        self._orig = {}
        self._c0 = {}

    # -------------------------------------------------------- the window

    def start(self) -> None:
        from cloudberry_tpu_torch.exec import cuda_kernels as CK

        self._c0 = self.session.stmt_log.counter_snapshot()
        for k in KERNELS:
            self._orig[k] = getattr(CK, k)
            setattr(CK, k, self._wrap(k, self._orig[k]))
        if self.on_card:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
            torch.cuda.synchronize()
            self._mark = time.perf_counter()
            torch.cuda._sleep(1000)
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        from cloudberry_tpu_torch.exec import cuda_kernels as CK

        if self.on_card:
            torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        if self._prof is not None:
            self._prof.stop()
        for k, fn in self._orig.items():
            setattr(CK, k, fn)
        c1 = self.session.stmt_log.counter_snapshot()
        self.counters = {k: c1.get(k, 0) - self._c0.get(k, 0)
                         for k in set(c1) | set(self._c0)}

    def _wrap(self, kernel: str, fn):
        count = getattr(_roofline, f"{kernel}_bytes")
        records = self.launches[kernel]

        def wrapper(*args, **kw):
            records.append(count(*args, **kw))
            return fn(*args, **kw)

        return wrapper

    # ---------------------------------------------------- after the window

    def collect(self) -> None:
        """Read the spans and the profiler's device timeline."""
        self.spans = [ex for ex in self.session.stmt_log.traces(limit=1 << 30)
                      if self._root(ex) is not None]
        for k in KERNELS:
            self.launches[k] = [r.resolve() for r in self.launches[k]]
        if self._prof is not None:
            self._read_profile()
            self._prof = None
        # the program's state must go before the reference runs
        self.session = None

    @staticmethod
    def _root(ex: dict):
        for ev in ex.get("events", ()):
            if ev["name"] == "statement":
                return ev
        return None

    def statements(self) -> list[dict]:
        """Each statement that started in the window: its root span's
        start and end (s), its sql (first 200 characters) and its spans
        by name (summed seconds)."""
        out = []
        for ex in self.spans:
            root = self._root(ex)
            t0 = root["ts"] / 1e6
            if not self.t_start <= t0 <= self.t_stop:
                continue
            by = {}
            for ev in ex["events"]:
                by[ev["name"]] = by.get(ev["name"], 0.0) + ev["dur"] / 1e6
            out.append({"t0": t0, "t1": t0 + root["dur"] / 1e6,
                        "sql": ex["sql"], "spans": by})
        return sorted(out, key=lambda s: s["t0"])

    def _read_profile(self) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and "ts" in e and "dur" in e]
        spin = [e for e in dev if "spin_kernel" in e.get("name", "")]
        if not spin:
            return
        offset = min(e["ts"] for e in spin) / 1e6 - self._mark
        self.device_ops = sorted(
            (e["ts"] / 1e6 - offset, e["dur"] / 1e6, e.get("name", "?"))
            for e in dev if e not in spin)
        busy = 0.0
        end = self.t_start
        for t0, dur, _ in self.device_ops:
            a, b = max(t0, end), min(t0 + dur, self.t_stop)
            if b > a:
                busy += b - a
                end = b
        self.window_s = self.t_stop - self.t_start
        self.busy_s = busy

    def kernel_seconds(self, kernel: str) -> float:
        names = KERNEL_NAMES[kernel]
        return sum(d for _, d, n in self.device_ops
                   if any(k in n for k in names))

    def idle_gaps(self) -> list[tuple[float, float]]:
        """The device's idle intervals within the window."""
        gaps, end = [], self.t_start
        for t0, dur, _ in self.device_ops:
            if t0 > end:
                gaps.append((end, min(t0, self.t_stop)))
            end = max(end, t0 + dur)
            if end >= self.t_stop:
                break
        if end < self.t_stop:
            gaps.append((end, self.t_stop))
        return [(a, b) for a, b in gaps if b > a]

    def host_activity(self) -> list[tuple[float, float, str]]:
        """The program's host spans of the window: (start, end, name)."""
        out = []
        for ex in self.spans:
            for ev in ex["events"]:
                out.append((ev["ts"] / 1e6, (ev["ts"] + ev["dur"]) / 1e6,
                            ev["name"]))
        return sorted(out)

    def breakdown(self) -> dict:
        if not self.device_ops:
            return {"device_ops": [], "idle_gaps": []}
        by_op: dict[str, float] = {}
        for _, dur, name in self.device_ops:
            by_op[name[:120]] = by_op.get(name[:120], 0.0) + dur
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        # each idle gap goes to the innermost host span open at its middle
        spans = self.host_activity()
        active: list[tuple[float, float, str]] = []
        j = 0
        by_host: dict[str, float] = {}
        for a, b in self.idle_gaps():
            m = (a + b) / 2
            while j < len(spans) and spans[j][0] <= m:
                active.append(spans[j])
                j += 1
            active = [s for s in active if s[1] >= m]
            name = min(active, key=lambda s: s[1] - s[0])[2] if active \
                else "no statement (client, wire, server)"
            by_host[name] = by_host.get(name, 0.0) + (b - a)
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}
