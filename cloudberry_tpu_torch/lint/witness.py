"""Runtime lock-order witness — the dynamic half of the lock pass.

The static pass proves the acquisition graph it can SEE is acyclic; this
module asserts the declared order on paths the AST cannot see (callbacks,
locals aliasing locks, cross-thread handoffs). ``install()`` patches
``threading.Lock``/``RLock`` with a factory that, per allocation, walks
the creation stack to the first engine frame and matches it against the
static lock table (the same discovery the lint pass runs): locks created
at KNOWN sites come back wrapped with their declared rank
(config.WITNESS_ORDER); everything else stays a raw primitive — zero
overhead outside the engine's own locks.

Each wrapped acquisition checks the per-thread held stack: acquiring a
lock whose rank is LOWER OR EQUAL to the top of the stack (other than
re-entering the very same object) is an order violation, recorded in
``violations()`` (and raised immediately in ``strict`` mode). The
lifecycle/tenancy/shared-cache suites enable the witness around their
tests and assert the violation list stays empty.

``threading.Condition`` needs no patch: a Condition built over a wrapped
lock synchronizes THROUGH the wrapper (acquire/release fall back to the
proxy's methods), and a bare ``Condition()`` builds its internal RLock
via the patched ``threading.RLock`` — so condition waits release and
re-acquire under witness too.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass


@dataclass
class Violation:
    thread: str
    holding: tuple          # (name, rank) stack at the time
    acquiring: str
    rank: int
    site: str               # file:line of the acquiring call

    def render(self) -> str:
        held = " > ".join(f"{n}(r{r})" for n, r in self.holding)
        return (f"[{self.thread}] acquired {self.acquiring}"
                f"(r{self.rank}) while holding {held} at {self.site}")


class _State:
    def __init__(self):
        self.installed = False
        self.depth = 0          # nested install() refcount
        self.strict = False
        self.real_lock = None
        self.real_rlock = None
        self.site_map: dict[tuple, tuple] = {}   # (file,line)->(name,rank)
        # module-level declared locks ("faultinject._lock"): created at
        # IMPORT time, usually before install() patches threading — they
        # are wrapped in place by swapping the module attribute
        self.module_locks: list[tuple] = []      # (name, rank, stem, attr)
        self.wrapped_module_attrs: list[tuple] = []  # (module, attr, raw)
        self.violations: list[Violation] = []
        self.vlock = threading.Lock()  # guards the violations list only
        self.tls = threading.local()


_state = _State()


def _held_stack():
    st = getattr(_state.tls, "stack", None)
    if st is None:
        st = _state.tls.stack = []
    return st


class WitnessedLock:
    """Order-checking proxy over a real Lock/RLock. Exposes the full
    primitive protocol (acquire/release/locked/context manager) so
    Condition(lock=proxy) and bare with-blocks both ride through it."""

    __slots__ = ("_real", "name", "rank", "_reentrant")

    def __init__(self, real, name: str, rank: int, reentrant: bool):
        self._real = real
        self.name = name
        self.rank = rank
        self._reentrant = reentrant

    # ------------------------------------------------------------ checks

    def _check_order(self) -> None:
        stack = _held_stack()
        if not stack:
            return
        if self._reentrant and any(obj is self for _n, _r, obj in stack):
            return  # re-entry of a held RLock is not an ordering event
        # check against EVERY held lock, not just the top: after a
        # first violation the stack is no longer monotonic, and a
        # top-only comparison would swallow the rest of the cascade
        offending = any(r >= self.rank for _n, r, obj in stack
                        if obj is not self)
        if offending:
            v = Violation(
                thread=threading.current_thread().name,
                holding=tuple((n, r) for n, r, _o in stack),
                acquiring=self.name, rank=self.rank,
                site=_caller_site())
            with _state.vlock:
                _state.violations.append(v)
            if _state.strict:
                raise AssertionError("lock-order violation: " + v.render())

    # --------------------------------------------------------- primitive

    def acquire(self, blocking=True, timeout=-1):
        self._check_order()
        got = self._real.acquire(blocking, timeout)
        if got:
            _held_stack().append((self.name, self.rank, self))
        return got

    def release(self):
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][2] is self:
                del stack[i]
                break
        self._real.release()

    def locked(self):
        return self._real.locked()

    # --------------------------- threading.Condition integration
    # Condition(lock=proxy) and Condition() (whose internal RLock the
    # patched factory wrapped) synchronize through these; without them
    # Condition falls back to acquire(0) probing, which misreads a HELD
    # re-entrant lock as un-owned (RLock.acquire(0) succeeds for the
    # owning thread) and raises "cannot notify on un-acquired lock".

    def _is_owned(self):
        if hasattr(self._real, "_is_owned"):
            return self._real._is_owned()
        if self._real.acquire(False):
            self._real.release()
            return False
        return True

    def _release_save(self):
        if hasattr(self._real, "_release_save"):
            state = self._real._release_save()
        else:
            self._real.release()
            state = None
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][2] is self:
                del stack[i]
                break
        return state

    def _acquire_restore(self, state):
        if hasattr(self._real, "_acquire_restore"):
            self._real._acquire_restore(state)
        else:
            self._real.acquire()
        _held_stack().append((self.name, self.rank, self))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<WitnessedLock {self.name} r{self.rank} {self._real!r}>"


def _caller_site() -> str:
    import sys

    try:
        f = sys._getframe(3)
    except ValueError:
        return "?"
    for _ in range(12):
        if f is None:
            break
        fn = f.f_code.co_filename
        if "cloudberry_tpu_torch" in fn and "lint" not in fn.split(os.sep)[-2:]:
            rel = fn[fn.rfind("cloudberry_tpu_torch"):].replace(os.sep, "/")
            return f"{rel}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _creation_site_key():
    """Walk the creation stack (past threading.py / dataclasses) to the
    first engine frame; returns (relpath, lineno) to match the static
    lock table."""
    import sys

    f = sys._getframe(2)
    for _ in range(16):
        if f is None:
            return None
        fn = f.f_code.co_filename
        base = os.path.basename(fn)
        if "cloudberry_tpu_torch" in fn and base != "witness.py" \
                and "threading" not in base:
            rel = fn[fn.rfind("cloudberry_tpu_torch"):].replace(os.sep, "/")
            return (rel, f.f_lineno)
        f = f.f_back
    return None


def _factory(real_ctor, reentrant: bool):
    def make():
        real = real_ctor()
        key = _creation_site_key()
        if key is None:
            return real
        hit = _state.site_map.get(key)
        if hit is None:
            return real
        name, rank = hit
        return WitnessedLock(real, name, rank, reentrant)

    return make


def _build_site_map() -> dict[tuple, tuple]:
    """Static lock discovery (the lint pass) → creation-site map with
    declared ranks. Aliased locks (Condition(self._lock)) inherit their
    canonical lock's rank; undeclared locks stay unwitnessed. Declared
    MODULE-LEVEL locks are also collected for in-place wrapping (their
    creation ran at import, before any install())."""
    import cloudberry_tpu_torch
    from cloudberry_tpu_torch.lint.config import LintConfig, witness_ranks
    from cloudberry_tpu_torch.lint.core import run_lint

    pkg_dir = os.path.dirname(os.path.abspath(cloudberry_tpu_torch.__file__))
    result = run_lint([pkg_dir], LintConfig())
    ranks = witness_ranks()
    out: dict[tuple, tuple] = {}
    _state.module_locks = []
    for name, (file, line, _kind, alias_of) in result.lock_sites.items():
        rank = ranks.get(name)
        if rank is None and alias_of is not None:
            rank = ranks.get(alias_of)
        if rank is None:
            continue
        # file is relative to the package parent; creation frames give
        # paths containing "cloudberry_tpu_torch/..."
        out[(file, line)] = (name, rank)
        stem, attr = name.split(".", 1)
        if file.rsplit("/", 1)[-1] == f"{stem}.py" and "." not in attr:
            # "<modstem>.<attr>" where the stem IS the defining file:
            # a module-global lock, wrappable by attribute swap
            _state.module_locks.append((name, rank, stem, attr))
    return out


def _wrap_module_locks() -> None:
    """Swap already-created module-global locks (faultinject._lock,
    sharedcache._tier_lock) for witnessed proxies: every use site reads
    the module global at acquisition time, so the swap takes effect
    immediately. Modules imported AFTER install() need no swap — their
    creation goes through the patched factory."""
    import sys

    for name, rank, stem, attr in _state.module_locks:
        for mkey, module in list(sys.modules.items()):
            if not mkey.startswith("cloudberry_tpu_torch") \
                    or mkey.rsplit(".", 1)[-1] != stem:
                continue
            raw = getattr(module, attr, None)
            if raw is None or isinstance(raw, WitnessedLock):
                continue
            if not (hasattr(raw, "acquire") and hasattr(raw, "release")):
                continue
            setattr(module, attr, WitnessedLock(raw, name, rank,
                                                reentrant=False))
            _state.wrapped_module_attrs.append((module, attr, raw))


def install(strict: bool = False) -> None:
    """Enable the witness: new engine locks created at declared sites
    come back wrapped. REFCOUNTED: nested installs (a test calling
    install() inside a suite whose fixture already did) stack, and only
    the matching outermost ``uninstall()`` restores threading — an
    inner scope can never silently disarm an outer one. Only locks
    created AFTER the first install are witnessed — suites install it
    before building their servers/schedulers."""
    if _state.installed:
        _state.depth += 1
        _state.strict = strict
        return
    if not _state.site_map:
        # one static discovery per process: the lock table only changes
        # with the source tree, and repeated installs (per-suite test
        # fixtures) must not pay the scan again
        _state.site_map = _build_site_map()
    _state.real_lock = threading.Lock
    _state.real_rlock = threading.RLock
    _state.strict = strict
    _state.violations = []
    threading.Lock = _factory(_state.real_lock, reentrant=False)
    threading.RLock = _factory(_state.real_rlock, reentrant=True)
    _wrap_module_locks()
    _state.installed = True
    _state.depth = 1


def uninstall() -> None:
    if not _state.installed:
        return
    _state.depth -= 1
    if _state.depth > 0:
        return  # an outer watching()/install scope is still active
    threading.Lock = _state.real_lock
    threading.RLock = _state.real_rlock
    for module, attr, raw in _state.wrapped_module_attrs:
        # only restore what we put there (a reload may have replaced it)
        if isinstance(getattr(module, attr, None), WitnessedLock):
            setattr(module, attr, raw)
    _state.wrapped_module_attrs = []
    # module globals wrapped by the FACTORY (module imported after
    # install) unwrap here too, so no proxy outlives the session
    import sys

    for _name, _rank, stem, attr in _state.module_locks:
        for mkey, module in list(sys.modules.items()):
            if mkey.startswith("cloudberry_tpu_torch") \
                    and mkey.rsplit(".", 1)[-1] == stem:
                cur = getattr(module, attr, None)
                if isinstance(cur, WitnessedLock):
                    setattr(module, attr, cur._real)
    _state.installed = False


def violations() -> list[Violation]:
    with _state.vlock:
        return list(_state.violations)


def reset_violations() -> None:
    with _state.vlock:
        _state.violations.clear()


def witnessed_site_count() -> int:
    """How many declared lock sites the witness knows (0 means the
    static discovery failed — suites assert this is non-zero so the
    witness can never silently watch nothing)."""
    return len(_state.site_map)


@contextlib.contextmanager
def watching(strict: bool = False):
    """The test-suite harness in one place: install, watch, and FAIL on
    any recorded violation at exit. Suites wrap their module in
    ``with witness.watching(): yield`` from an autouse fixture.

    Known limit: locks built by dataclass ``field(default_factory=
    threading.Lock)`` bind the REAL constructor at class-definition
    time (import), so they are never wrapped — keep such locks out of
    WITNESS_ORDER (the static pass still audits them)."""
    install(strict=strict)
    reset_violations()
    assert witnessed_site_count() > 0, \
        "witness site map is empty — static lock discovery failed"
    try:
        yield
    finally:
        vs = violations()
        uninstall()
        reset_violations()
        assert not vs, "lock-order violations:\n" + "\n".join(
            v.render() for v in vs)
