"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

Everything that belongs to a configuration, a traffic mix, a template or
a metric is a file of its own, found by the name that ``BENCHMARK.json``
gives: ``configs/<config>.json``, ``traffic/<mix>.json``,
``templates/<family>/<template>.json``, ``gen/<family>.py``,
``reference/<family>/<template>.py`` and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from cbbench import check, traffic
from cbbench.check import Gaps

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# how long after the window's close a statement may still answer
LATE_S = 60.0


@dataclass
class Request:
    client: int
    stmt: traffic.Statement
    sql: str
    t_send: float
    t_recv: float | None = None
    rows: list | None = None
    error: str | None = None


@dataclass
class Window:
    t0: float
    t1: float
    requests: list[Request] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def done(self) -> list[Request]:
        """Statements answered within the window."""
        return [r for r in self.answered() if r.t_recv <= self.t1]

    def answered(self) -> list[Request]:
        """Statements sent within the window and answered, also those
        that answered after its close: the latencies are theirs, so a
        long statement or a stall that straddles the close counts."""
        return [r for r in self.requests if r.error is None
                and r.t_recv is not None]


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(items: list[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, cell: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of
    the name's part before its first dot (``p95_ms.<cell>`` reads as
    ``p95_ms``)."""
    for stem in (name, name.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            mod_spec = importlib.util.spec_from_file_location(
                f"cbbench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(mod_spec)
            mod_spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for metric {name!r} under cbbench/metrics")


def _port_config(overrides: dict, traced: bool):
    from cloudberry_tpu_torch.config import Config

    kv = dict(overrides)
    if traced:
        # keep every statement's spans of the window (the default ring
        # keeps the newest 64)
        kv["obs.trace_ring"] = 1 << 20
    return Config().with_overrides(**kv)


def _client_loop(server, traffic_, templates, i, start: threading.Event,
                 window: Window, out: list, ready: threading.Barrier):
    from cloudberry_tpu_torch.serve.client import Client, ServerError

    c = Client(server.host, server.port, timeout=600.0)
    stmts = traffic_.client(i)
    try:
        ready.wait()
        start.wait()
        while time.perf_counter() < window.t1:
            st = next(stmts)
            sql = st.sql(templates)
            req = Request(i, st, sql, time.perf_counter())
            out.append(req)
            try:
                req.rows = c.sql(sql)["rows"]
            except ServerError as e:
                req.error = f"{e.etype}: {e}"
            req.t_recv = time.perf_counter()
    finally:
        c.close()


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", scale: float | None = None,
             t_start: float | None = None, root: Path = ROOT,
             log=print) -> dict:
    """One run; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(root)
    cell = _named(spec["workloads"], cell_name, "workload")
    cfg_entry = _named(spec["configs"], cell["config"], "config")
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = traffic.load_mix(cell["traffic"])
    if mix["family"] != config["family"]:
        raise SystemExit(f"mix {cell['traffic']} is {mix['family']}, config "
                         f"{cell['config']} is {config['family']}")
    if mix.get("loop", "closed") != "closed":
        raise SystemExit("only closed-loop mixes are driven")
    templates = traffic.load_templates(mix["family"], mix["templates"])
    tables = sorted({t for tpl in templates.values() for t in tpl["tables"]})
    gen = importlib.import_module(f"cbbench.gen.{mix['family']}")
    on_card = torch.device(device).type == "cuda"

    # 1. set-up: the data, made on the device from the seed
    made = gen.make(config["scale"] if scale is None else scale, seed,
                    device, tables)
    if on_card:
        torch.cuda.synchronize()
    t_made = time.perf_counter()
    host = {t: m.to_host() for t, m in made.items()}
    del made
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_gen = time.perf_counter()

    import cloudberry_tpu_torch as cb
    from cloudberry_tpu_torch.catalog.carry import field as port_field
    from cloudberry_tpu_torch.catalog.carry import load_encoded
    from cloudberry_tpu_torch.serve.client import Client
    from cloudberry_tpu_torch.serve.server import Server

    session = cb.Session(_port_config(config.get("program", {}), traced),
                         device=device)
    for name in tables:
        h = host[name]
        load_encoded(session, name,
                     [port_field(n, b, s) for n, b, s in h.fields],
                     h.columns, dict_values=h.dicts)
    if on_card:
        from cloudberry_tpu_torch.exec import cuda_kernels

        cuda_kernels.build()
    t_load = time.perf_counter()
    server = Server(session=session).start()
    tr = traffic.Traffic(mix, templates, seed)
    with Client(server.host, server.port, timeout=600.0) as c:
        for rnd in range(2):
            for st in tr.warmup():
                t = time.perf_counter()
                c.sql(st.sql(templates))
                log(f"warm-up {rnd} {st.template} "
                    f"{time.perf_counter() - t:.3f} s", file=sys.stderr)
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    t_warm = time.perf_counter()
    log(f"set-up: data made {t_made - t_start:.3f} s, copied to the host "
        f"{t_gen - t_made:.3f} s, loaded {t_load - t_gen:.3f} s, warm-up "
        f"{t_warm - t_load:.3f} s", file=sys.stderr)

    # 2. the window: the mix's clients, closed loop
    tracer = None
    if traced:
        from cbbench.tracing import Tracer

        tracer = Tracer(session, on_card)
    n_clients = int(mix["clients"])
    start = threading.Event()
    ready = threading.Barrier(n_clients + 1)
    window = Window(0.0, math.inf)
    outs: list[list[Request]] = [[] for _ in range(n_clients)]
    threads = [threading.Thread(target=_client_loop, daemon=True,
                                args=(server, tr, templates, i, start,
                                      window, outs[i], ready))
               for i in range(n_clients)]
    for t in threads:
        t.start()
    ready.wait()
    setup_s = time.perf_counter() - t_start
    if tracer is not None:
        tracer.start()
    window.t0 = time.perf_counter()
    window.t1 = window.t0 + seconds
    start.set()
    for t in threads:
        t.join(timeout=max(0.0, window.t1 + LATE_S - time.perf_counter()))
    window.requests = sorted((r for o in outs for r in o),
                             key=lambda r: r.t_send)
    unanswered = sum(r.t_recv is None for r in window.requests)
    if tracer is not None:
        tracer.stop()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # 3. the program's state goes before the reference runs
    server.stop()
    if tracer is not None:
        tracer.collect()
    del session, server
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if tracer is not None:
        for k, launches in tracer.launches.items():
            log(f"kernel {k}: {len(launches)} launches, {sum(launches)} B, "
                f"{tracer.kernel_seconds(k):.6f} s on the device",
                file=sys.stderr)
    t_check = time.perf_counter()
    gaps = verify(host, tr, window.requests, device)
    log(f"check: {gaps.checked} answers in {time.perf_counter() - t_check:.3f}"
        f" s; run {time.perf_counter() - t_start:.3f} s", file=sys.stderr)
    gaps.unanswered += unanswered
    gaps.failed += sum(r.error is not None for r in window.requests)
    del host
    gc.collect()

    # 4. the result line
    ctx = Context(cell_name, window, setup_s, tracer, on_card)
    metrics = {}
    for m in metrics_of(spec, cell_name, traced):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": gaps.correct(),
           "attempted": len(window.requests), "failed": gaps.failed,
           "metrics": metrics, "device": dev}
    if tracer is not None:
        dev["busy_s"] = tracer.busy_s
        dev["window_s"] = tracer.window_s
        out["breakdown"] = tracer.breakdown()
    out["compared"] = {k: {"value": v, "limit": check.LIMITS[k]}
                       for k, v in gaps.numbers().items()}
    return out


def verify(host, tr: traffic.Traffic, requests: list[Request],
           device) -> Gaps:
    """Check the answers of a sample of the window's distinct statements
    (every answer of each) against the plain reference."""
    from cbbench.reference.common import DB

    family = tr.mix["family"]
    keys = tr.check_sample([r.stmt.key for r in requests
                            if r.rows is not None])
    db = DB(host, device)
    gaps = Gaps()
    for key in keys:
        mod = importlib.import_module(f"cbbench.reference.{family}.{key[0]}")
        ref = mod.answer(db, dict(key[1]))
        for r in requests:
            if r.rows is not None and r.stmt.key == key:
                gaps.add(check.compare(ref, r.rows))
    db.free()
    return gaps


@dataclass
class Context:
    """What a metric's reader is handed."""

    cell: str
    window: Window
    setup_s: float
    tracer: object | None
    on_card: bool
