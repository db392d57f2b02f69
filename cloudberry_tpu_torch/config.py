"""Typed configuration tree — the GUC system analog.

The reference keeps ~6k lines of GUCs (``src/backend/utils/misc/guc_gp.c``).
Here configuration is a typed, immutable dataclass tree; a session carries
one, and ``with_overrides`` produces a modified copy. This port carries the
fields its single-segment slice reads. There is no counterpart of the JAX
package's ``exec.use_pallas``: the kernel gates are decided by the plan's
shapes alone, and on a CUDA device the hand-written kernels always run.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class PlannerConfig:
    """Planner settings the single-segment slice reads."""

    # Auto-ANALYZE after DML (the gp_autostats_mode analog,
    # autostats.c:283): "none" | "on_no_stats" (first DML on an
    # unanalyzed table) | "on_change" (row count drifted more than
    # autostats_threshold since the last ANALYZE).
    autostats: str = "on_no_stats"
    autostats_threshold: float = 0.2


@dataclass(frozen=True)
class Config:
    planner: PlannerConfig = field(default_factory=PlannerConfig)

    def with_overrides(self, **kv: Any) -> "Config":
        """Return a copy with dotted-path overrides, e.g.
        ``cfg.with_overrides(**{"planner.autostats": "none"})``."""
        out = self
        for path, value in kv.items():
            parts = path.split(".")
            out = _replace_path(out, parts, value)
        return out


def _replace_path(node: Any, parts: list[str], value: Any) -> Any:
    if len(parts) == 1:
        return dataclasses.replace(node, **{parts[0]: value})
    child = getattr(node, parts[0])
    return dataclasses.replace(node, **{parts[0]: _replace_path(child, parts[1:], value)})


_global_config = Config()


def get_config() -> Config:
    return _global_config


def set_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
