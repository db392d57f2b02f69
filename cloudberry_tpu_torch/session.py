"""Session — the QD (query dispatcher) analog, single segment.

``sql()`` runs the pipeline: parse → bind/plan → execute on the session's
device. A Session with no device runs on CUDA and raises when no CUDA
device is available; it never moves to the CPU by itself. The tests ask
for ``device="cpu"``, which runs the kernels' plain versions.

A join-expansion overflow (more match pairs than the planner's estimate)
grows the join's pair buffer and runs the statement again
(``growth_events`` counts the growths). The reference also re-checks
admission and may fall back to tiled execution there; the port has
neither yet, so it only grows and retries.

Not ported yet: more than one segment, UPDATE/DELETE (each raises
``NotImplementedError`` where reached), generic plans, transactions,
durable storage, tiled (out-of-core) execution, admission control,
serving and the metrics plane.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from cloudberry_tpu_torch.config import Config, get_config


class Session:
    def __init__(self, config: Config | None = None, device=None):
        from cloudberry_tpu_torch.catalog.catalog import Catalog

        self.config = config or get_config()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "cloudberry_tpu_torch.Session() runs on CUDA and no "
                    "CUDA device is available; pass device='cpu' to run "
                    "the kernels' plain versions on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available")
        self.catalog = Catalog()
        # device copies of RAM tables: name -> (table version, columns)
        self._device_tables: dict[str, tuple[int, dict]] = {}
        # join-expansion buffers grown by statement retries
        self.growth_events = 0

    def sql(self, query: str, **params: Any):
        """Run one statement: DDL/DML returns its status string, a SELECT
        its ColumnBatch."""
        from cloudberry_tpu_torch.plan.planner import plan_statement
        from cloudberry_tpu_torch.sql.parser import parse_sql

        result = plan_statement(parse_sql(query), self, params)
        if result.is_ddl:
            return result.ddl_result
        return self._run_with_growth(result.plan)

    def _run_with_growth(self, plan):
        """Execute; on a detected join-expansion overflow, grow the pair
        buffer and retry — adaptive capacity, never truncation
        (exec/executor.py:grow_expansion). Six growths at most (4x each),
        then a last run whose error surfaces."""
        from cloudberry_tpu_torch.exec.executor import (ExecError, execute,
                                                        grow_expansion)

        for _ in range(6):
            try:
                return execute(plan, self)
            except ExecError as e:
                if not grow_expansion(plan, str(e), allow_fallback=True):
                    raise
                self.growth_events += 1
        return execute(plan, self)

    def explain(self, query: str) -> str:
        """The plan text of a statement, without running it (one
        segment: no distribution annotation)."""
        from cloudberry_tpu_torch.plan.planner import plan_statement
        from cloudberry_tpu_torch.sql.parser import parse_sql

        result = plan_statement(parse_sql(query), self, {},
                                explain_only=True)
        if result.is_ddl:
            return str(result.ddl_result)
        return result.plan.explain()

    def device_table(self, name: str) -> dict:
        """A table's columns (and ``$nn:<col>`` validity masks) as tensors
        on the session's device, copied once per table version."""
        t = self.catalog.table(name)
        version = getattr(t, "_version", 0)
        hit = self._device_tables.get(name)
        if hit is not None and hit[0] == version:
            return hit[1]
        cols = {c: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for c, v in t.data.items()}
        for c, vm in t.validity.items():
            cols[f"$nn:{c}"] = torch.from_numpy(
                np.asarray(vm, dtype=np.bool_)).to(self.device)
        self._device_tables[name] = (version, cols)
        return cols
