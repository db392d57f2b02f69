"""graftlint — project-invariant static analysis for the concurrent core.

Generic linters check style; this one checks the INVARIANTS this engine's
concurrency and kernel layers rely on but that otherwise live only in
prose and reviewers' heads (the reference enforces the same
class of discipline with compiled-in assertions and the faultinjector —
SURVEY §4.2/§5.2):

- **lock discipline** (``lock-order``, ``lock-unguarded``, ``lock-held-call``)
  — every ``threading.Lock/RLock/Condition`` attribute is discovered, the
  static acquisition-order graph is built from nested ``with`` blocks and
  calls made while holding a lock, and cycles (potential deadlock), calls
  that re-acquire a held non-reentrant lock, and writes to mixed-guard
  shared attributes outside any lock are findings;
- **trace purity** (``purity-*``) — inside jitted/Pallas-kernel functions,
  host-side escapes are findings: ``np.*`` on traced values,
  ``.item()``/``float()``/``int()`` coercions, Python branching on tracer
  values, f32 accumulation of int64/DECIMAL values outside the limb
  convention;
- **taxonomy integrity** (``tax-*``) — every error dict serialized to the
  wire carries the ``retryable`` stamp, and every name the client retries
  BY NAME (lifecycle._RETRYABLE_NAMES) exists and round-trips;
- **seam integrity** (``seam-*``) — every ``fault_point`` call site appears
  in the faultinject INVENTORY (and vice versa), and every unbounded
  tile/retry loop contains a ``check_cancel()`` seam.

Per-site suppressions: ``# graftlint: ignore[rule]`` (with a justification
after the bracket — the clean gate requires one). Machine-readable output:
``python -m cloudberry_tpu_torch.lint --json``; the lock graph:
``python -m cloudberry_tpu_torch.lint --dot``.

The static passes are complemented by a RUNTIME lock-order witness
(lint/witness.py): a debug-mode wrapper asserting the declared acquisition
order on dynamic paths the AST cannot see, enabled under the
lifecycle/tenancy/shared-cache test suites.
"""

from cloudberry_tpu_torch.lint.core import (  # noqa: F401
    Finding,
    LintResult,
    run_lint,
)
