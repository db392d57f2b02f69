"""Unified observability plane: statement trace spans (obs/trace.py),
the metrics registry (obs/metrics.py), per-skeleton statement aggregates
(obs/statements.py), per-statement device-memory accounting and memory
gauges (obs/capacity.py), live statement progress (obs/progress.py), and
the slow-statement flight recorder (obs/flightrec.py). A session's
StatementLog (exec/instrument.py) owns one instance of each."""

from cloudberry_tpu_torch.obs.metrics import (CounterView,  # noqa: F401
                                        MetricsRegistry, observe_stage)
from cloudberry_tpu_torch.obs.progress import (Progress,  # noqa: F401
                                         current_progress)
from cloudberry_tpu_torch.obs.statements import StatementStats  # noqa: F401
from cloudberry_tpu_torch.obs.trace import (Trace, chrome_trace,  # noqa: F401
                                      current_trace, device_annotation,
                                      mark, span)
