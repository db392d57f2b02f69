"""Session — the QD (query dispatcher) analog, single segment.

``sql()`` runs the pipeline: parse → bind/plan → execute on the session's
device. A Session with no device runs on CUDA and raises when no CUDA
device is available; it never moves to the CPU by itself. The tests ask
for ``device="cpu"``, which runs the kernels' plain versions.

Not ported yet: more than one segment, UPDATE/DELETE (each raises
``NotImplementedError`` where reached), generic plans, transactions,
durable storage, tiled (out-of-core) execution, serving and the metrics
plane. A join-expansion overflow raises ``ExecError``: the JAX package's
capacity-growth retry is not ported, since TPC-H Q1/Q3/Q5 never need it.
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

    def sql(self, query: str, **params: Any):
        """Run one statement: DDL/DML returns its status string, a SELECT
        its ColumnBatch."""
        from cloudberry_tpu_torch.exec.executor import execute
        from cloudberry_tpu_torch.plan.planner import plan_statement
        from cloudberry_tpu_torch.sql.parser import parse_sql

        result = plan_statement(parse_sql(query), self, params)
        if result.is_ddl:
            return result.ddl_result
        return execute(result.plan, self)

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
