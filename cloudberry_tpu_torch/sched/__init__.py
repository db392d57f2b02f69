"""Statement scheduler — parameterized generic plans + the continuous
micro-batch dispatcher (the plan_cache.c / gang-dispatch analog).

- ``paramplan``: literal parameterization. Same-shape statements share ONE
  Executable keyed on the normalized statement skeleton, with literals fed
  as device inputs (``$params``), and the dispatcher's stacked launch.
- ``dispatcher``: a bounded request queue in front of a serving Session
  that coalesces same-skeleton statements per tick into one stacked
  launch.
- ``sharedcache``: the cache scopes sessions over one store share.
- ``tenancy``: per-tenant fair scheduling — named resource groups picked
  in deficit-weighted-round-robin order inside the dispatcher tick, with
  starvation-free aging and per-tenant backpressure (TenantQueueFull).
"""

from cloudberry_tpu_torch.sched.paramplan import normalize  # noqa: F401
from cloudberry_tpu_torch.sched.dispatcher import (  # noqa: F401
    Dispatcher, SchedDeadline, SchedQueueFull)
from cloudberry_tpu_torch.sched.tenancy import TenantScheduler  # noqa: F401
