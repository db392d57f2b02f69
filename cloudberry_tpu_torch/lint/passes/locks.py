"""Lock-discipline pass — discovery, acquisition graph, cycles, guards.

Three rules:

- ``lock-order``: the static acquisition-order graph (edge A→B when B is
  acquired while A is held, including through calls) contains a cycle —
  two threads taking the cycle from different entry points can deadlock.
- ``lock-held-call``: a non-reentrant ``threading.Lock`` is (possibly
  transitively) re-acquired while already held on the same path — a
  guaranteed self-deadlock if the path executes.
- ``lock-unguarded``: a write to a MIXED-GUARD shared attribute outside
  any lock. An attribute of a lock-owning (or known-concurrent) class
  that is written under a lock somewhere and bare somewhere else has an
  inconsistent discipline; the bare site is the finding. Deliberate
  lock-free writes (single-owner-thread fields, monotonic flags) carry
  ``# graftlint: ignore[lock-unguarded]`` with a justification.

Discovery understands ``self.x = threading.Lock()/RLock()/Condition()``,
dataclass ``field(default_factory=threading.Lock)``, module-level locks,
and the ``Condition(self._lock)`` aliasing idiom (the condition IS the
lock). Cross-class edges resolve through parameter annotations and the
project wiring table (config.ATTR_CLASS_HINTS).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from cloudberry_tpu_torch.lint.core import Finding

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "cond"}

_MUTATING_METHODS = frozenset({
    "append", "appendleft", "extend", "extendleft", "add", "discard",
    "remove", "pop", "popleft", "popitem", "update", "clear",
    "setdefault", "insert", "rotate",
})

# lock-object methods that are synchronization, not attribute mutation
_SYNC_METHODS = frozenset({
    "acquire", "release", "wait", "wait_for", "notify", "notify_all",
    "locked", "set", "is_set",
})


@dataclass
class LockDef:
    node: str            # canonical graph-node name, "Class.attr"
    kind: str            # lock | rlock | cond
    file: str
    line: int
    alias_of: str | None = None   # Condition(self._lock) → the lock


@dataclass
class MethodInfo:
    cls: str              # owning class name ("" for module functions)
    name: str
    file: str
    module: str           # module stem, for module-level lock scoping
    # every lock node acquired anywhere in the body (with line numbers)
    acquires: dict = field(default_factory=dict)   # node -> line
    # calls: (held-locks-tuple, callee-key, line)
    calls: list = field(default_factory=list)
    # self-attribute writes: attr -> [(guarded_by_tuple, line)]
    writes: dict = field(default_factory=dict)
    # intra-class call sites into this method: [held-locks-tuple]
    called_with: list = field(default_factory=list)


def _ctor_kind(call: ast.AST) -> str | None:
    """'lock'/'rlock'/'cond' when ``call`` constructs a threading
    primitive (directly, via an import dance, or via
    field(default_factory=...))."""
    if not isinstance(call, ast.Call):
        return None
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _LOCK_CTORS:
        return _LOCK_CTORS[f.attr]
    if isinstance(f, ast.Name) and f.id in _LOCK_CTORS:
        return _LOCK_CTORS[f.id]
    if isinstance(f, ast.Name) and f.id == "field":
        for kw in call.keywords:
            if kw.arg == "default_factory":
                v = kw.value
                if isinstance(v, ast.Attribute) \
                        and isinstance(v.value, ast.Name) \
                        and v.value.id == "threading" \
                        and v.attr in _LOCK_CTORS:
                    return _LOCK_CTORS[v.attr]
    return None


def _self_attr(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class _Discovery(ast.NodeVisitor):
    """Collect lock definitions + class names for one module."""

    def __init__(self, mod, hints):
        self.mod = mod
        self.hints = hints
        self.module = mod.relpath.rsplit("/", 1)[-1][:-3]
        self.locks: dict[str, LockDef] = {}
        self.classes: set[str] = set()
        self._cls: str | None = None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev, self._cls = self._cls, node.name
        self.classes.add(node.name)
        for stmt in node.body:
            # dataclass field declaration: x: threading.Lock = field(...)
            if isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                    and isinstance(stmt.target, ast.Name):
                kind = _ctor_kind(stmt.value)
                if kind:
                    self._add(f"{node.name}.{stmt.target.id}", kind,
                              stmt.lineno, stmt.value)
            # property aliasing a nested object's lock:
            #   @property
            #   def _rung_lock(self): return self._cache_scope.rung_lock
            if isinstance(stmt, ast.FunctionDef) and any(
                    isinstance(d, ast.Name) and d.id == "property"
                    for d in stmt.decorator_list) \
                    and len(stmt.body) == 1 \
                    and isinstance(stmt.body[0], ast.Return):
                v = stmt.body[0].value
                if isinstance(v, ast.Attribute):
                    inner = _self_attr(v.value)
                    if inner is not None:
                        cls = self.hints.get(inner)
                        if cls:
                            self.locks[f"{node.name}.{stmt.name}"] = \
                                LockDef(f"{node.name}.{stmt.name}",
                                        "lock", self.mod.relpath,
                                        stmt.lineno,
                                        alias_of=f"{cls}.{v.attr}")
        self.generic_visit(node)
        self._cls = prev

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if self._cls is None:
            return  # module funcs hold no self-lock definitions
        for stmt in ast.walk(node):
            target = value = None
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                target, value = stmt.targets[0], stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                # annotated form: self._lock: threading.Lock = ...
                target, value = stmt.target, stmt.value
            if target is None:
                continue
            attr = _self_attr(target)
            kind = _ctor_kind(value)
            if attr and kind:
                self._add(f"{self._cls}.{attr}", kind, stmt.lineno,
                          value)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        # module-level lock: _lock = threading.Lock()
        if self._cls is None and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            kind = _ctor_kind(node.value)
            if kind:
                self._add(f"{self.module}.{node.targets[0].id}", kind,
                          node.lineno, node.value)

    def _add(self, name: str, kind: str, line: int, ctor: ast.AST) -> None:
        alias = None
        if kind == "cond" and isinstance(ctor, ast.Call) and ctor.args:
            attr = _self_attr(ctor.args[0])
            if attr and self._cls:
                alias = f"{self._cls}.{attr}"
        self.locks[name] = LockDef(name, kind, self.mod.relpath, line,
                                   alias)


class _MethodWalker:
    """Walk one function body tracking the held-lock stack."""

    def __init__(self, info: MethodInfo, ctx: "_Context"):
        self.info = info
        self.ctx = ctx
        self.held: list[str] = []
        # parameter annotations → class names (for conn.lock etc.)
        self.param_cls: dict[str, str] = {}
        # local aliases: lock = session._generic_lock; with lock: ...
        self.local_locks: dict[str, str] = {}

    # -------------------------------------------------- name resolution

    def lock_node(self, expr: ast.AST) -> str | None:
        """Resolve an expression used as a context manager (or
        acquire() target) to a canonical lock-graph node, or None."""
        attr = _self_attr(expr)
        if attr is not None and self.info.cls:
            return self.ctx.canonical(f"{self.info.cls}.{attr}")
        if isinstance(expr, ast.Name):
            if expr.id in self.local_locks:
                return self.local_locks[expr.id]
            return self.ctx.canonical(f"{self.info.module}.{expr.id}")
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name):
            base = expr.value.id
            cls = self.param_cls.get(base) \
                or self.ctx.hints.get(base)
            if cls:
                return self.ctx.canonical(f"{cls}.{expr.attr}")
        return None

    def callee_key(self, func: ast.AST) -> tuple[str, str] | None:
        """(class, method) or ("", module:function) for a call target we
        can resolve statically; None otherwise."""
        if isinstance(func, ast.Name):
            return self.ctx.resolve_func(self.info.module, func.id)
        if not isinstance(func, ast.Attribute):
            return None
        base = func.value
        attr = _self_attr(base)
        if attr is not None:
            # self.attr.m() — resolve attr's class via the wiring table
            cls = self.ctx.hints.get(attr)
            return (cls, func.attr) if cls else None
        if isinstance(base, ast.Name):
            if base.id == "self" and self.info.cls:
                return (self.info.cls, func.attr)
            cls = self.param_cls.get(base.id) or self.ctx.hints.get(base.id)
            if cls and cls in self.ctx.known_classes:
                return (cls, func.attr)
            if base.id in self.ctx.known_modules:
                # sharedcache.scope_for(...) — module-qualified call
                return ("", f"{base.id}:{func.attr}")
        return None

    # ---------------------------------------------------------- walking

    def walk_function(self, node: ast.FunctionDef) -> None:
        for a in list(node.args.args) + list(node.args.kwonlyargs):
            ann = a.annotation
            name = None
            if isinstance(ann, ast.Name):
                name = ann.id
            elif isinstance(ann, ast.Constant) and isinstance(ann.value,
                                                              str):
                name = ann.value.strip('"')
            elif isinstance(ann, ast.Attribute):
                name = ann.attr
            if name and name in self.ctx.known_classes:
                self.param_cls[a.arg] = name
        for stmt in node.body:
            self.visit(stmt)

    def visit(self, node: ast.AST) -> None:
        if isinstance(node, ast.With):
            self.visit_with(node)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # nested def/lambda: analyzed as part of this method (its
            # writes/acquisitions are the class's), but with a FRESH
            # held stack — the closure runs later, not under the locks
            # lexically held at its definition site
            saved, self.held = self.held, []
            body = node.body if isinstance(node.body, list) \
                else [node.body]
            for stmt in body:
                self.visit(stmt)
            self.held = saved
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self.record_write(node)
            # track `lock = <something resolvable to a lock>` aliases
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, (ast.Attribute, ast.Name)):
                ln = self.lock_node(node.value)
                if ln is not None:
                    self.local_locks[node.targets[0].id] = ln
        if isinstance(node, ast.Call):
            self.record_call(node)
        for child in ast.iter_child_nodes(node):
            self.visit(child)

    def visit_with(self, node: ast.With) -> None:
        pushed = []
        for item in node.items:
            ln = self.lock_node(item.context_expr)
            if ln is not None:
                self.record_acquire(ln, item.context_expr.lineno)
                self.held.append(ln)
                pushed.append(ln)
            else:
                # a non-lock context manager may still CALL things
                self.visit(item.context_expr)
        for stmt in node.body:
            self.visit(stmt)
        for _ in pushed:
            self.held.pop()

    # --------------------------------------------------------- recording

    def record_acquire(self, node_name: str, line: int) -> None:
        self.info.acquires.setdefault(node_name, line)
        for held in self.held:
            self.ctx.add_edge(held, node_name, self.info.file, line)
        if node_name in self.held:
            kind = self.ctx.kind_of(node_name)
            if kind == "lock":
                self.ctx.findings.append(Finding(
                    "lock-held-call", self.info.file, line,
                    f"non-reentrant lock {node_name} re-acquired while "
                    f"already held in {self.info.cls or self.info.module}"
                    f".{self.info.name} — self-deadlock"))

    def record_call(self, call: ast.Call) -> None:
        # container mutation counts as a write: self.X.append(...) /
        # self.X[k].pop() / self.stats.update(...)
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _MUTATING_METHODS:
            base = call.func.value
            if isinstance(base, ast.Subscript):
                base = base.value
            attr = _self_attr(base)
            if attr is not None:
                self._note_write(attr, call.lineno)
        # manual acquire: self.X.acquire()
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr == "acquire":
            ln = self.lock_node(call.func.value)
            if ln is not None:
                self.record_acquire(ln, call.lineno)
                return
        key = self.callee_key(call.func)
        if key is not None:
            # calls on lock objects themselves are synchronization
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _SYNC_METHODS:
                base_ln = self.lock_node(call.func.value)
                if base_ln is not None:
                    return
            self.info.calls.append((tuple(self.held), key, call.lineno))

    def record_write(self, node: ast.AST) -> None:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            attr = None
            if isinstance(t, ast.Tuple):
                for el in t.elts:
                    a = self._write_attr(el)
                    if a:
                        self._note_write(a, node.lineno)
                continue
            attr = self._write_attr(t)
            if attr:
                self._note_write(attr, node.lineno)

    def _write_attr(self, t: ast.AST) -> str | None:
        if isinstance(t, ast.Subscript):
            t = t.value
        return _self_attr(t)

    def _note_write(self, attr: str, line: int) -> None:
        self.info.writes.setdefault(attr, []).append(
            (tuple(self.held), line))


class _Context:
    def __init__(self, cfg):
        self.cfg = cfg
        self.hints = dict(cfg.attr_class_hints)
        self.locks: dict[str, LockDef] = {}
        self.known_classes: set[str] = set()
        self.known_modules: set[str] = set()
        # module-level function name -> {module stems defining it}
        self.func_homes: dict[str, set[str]] = {}
        self.graph: dict[str, dict[str, tuple]] = {}
        self.findings: list[Finding] = []
        self.methods: dict[tuple[str, str], MethodInfo] = {}

    def resolve_func(self, caller_module: str,
                     name: str) -> tuple[str, str] | None:
        """A bare f() call: same-module function first, else a uniquely
        named project function (imported via ``from x import f``);
        ambiguous names stay unresolved rather than guessing."""
        homes = self.func_homes.get(name, set())
        if caller_module in homes:
            return ("", f"{caller_module}:{name}")
        if len(homes) == 1:
            return ("", f"{next(iter(homes))}:{name}")
        return None

    def canonical(self, name: str) -> str | None:
        d = self.locks.get(name)
        if d is None:
            return None
        return d.alias_of if d.alias_of and d.alias_of in self.locks \
            else name

    def kind_of(self, name: str) -> str:
        d = self.locks.get(name)
        return d.kind if d else "lock"

    def add_edge(self, a: str, b: str, file: str, line: int) -> None:
        if a == b:
            return
        self.graph.setdefault(a, {}).setdefault(b, (file, line))


def run(modules, cfg, result) -> list[Finding]:
    ctx = _Context(cfg)

    # ---- phase 1: discovery across all modules
    discos = []
    for mod in modules:
        d = _Discovery(mod, ctx.hints)
        d.visit(mod.tree)
        discos.append((mod, d))
        ctx.known_classes |= d.classes
        ctx.known_modules.add(d.module)
        ctx.locks.update(d.locks)
        for item in mod.tree.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ctx.func_homes.setdefault(item.name, set()).add(d.module)

    # ---- phase 2: per-method walks
    for mod, d in discos:
        module = d.module

        def walk_func(fn: ast.FunctionDef, cls: str) -> None:
            info = MethodInfo(cls, fn.name, mod.relpath, module)
            w = _MethodWalker(info, ctx)
            w.walk_function(fn)
            ctx.methods[(cls, fn.name) if cls else
                        ("", f"{module}:{fn.name}")] = info

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        walk_func(item, node.name)
            elif isinstance(node, ast.Module):
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        walk_func(item, "")

    # ---- phase 3: transitive acquisition edges through calls
    eff_cache: dict[tuple, frozenset] = {}

    def effective_acquires(key, stack=()) -> frozenset:
        if key in eff_cache:
            return eff_cache[key]
        if key in stack or len(stack) > 12:
            return frozenset()
        info = ctx.methods.get(key)
        if info is None:
            return frozenset()
        out = set(info.acquires)
        for _held, callee, _line in info.calls:
            out |= effective_acquires(callee, stack + (key,))
        eff_cache[key] = frozenset(out)
        return eff_cache[key]

    for key, info in ctx.methods.items():
        for held, callee, line in info.calls:
            if not held:
                continue
            for lock in effective_acquires(callee):
                for h in held:
                    if h == lock:
                        if ctx.kind_of(lock) == "lock":
                            callee_name = ".".join(
                                k for k in callee if k) or str(callee)
                            ctx.findings.append(Finding(
                                "lock-held-call", info.file, line,
                                f"{lock} held here, and the call into "
                                f"{callee_name} can re-acquire it — "
                                "self-deadlock"))
                    else:
                        ctx.add_edge(h, lock, info.file, line)

    # record for callers (witness + --dot)
    result.lock_graph = ctx.graph
    result.lock_sites = {
        name: (d.file, d.line, d.kind, d.alias_of)
        for name, d in ctx.locks.items()}

    # ---- phase 4: cycle detection (iterative DFS, deterministic order)
    color: dict[str, int] = {}
    stack_path: list[str] = []
    cycles: list[list[str]] = []

    def dfs(n: str) -> None:
        color[n] = 1
        stack_path.append(n)
        for m in sorted(ctx.graph.get(n, ())):
            if color.get(m, 0) == 0:
                dfs(m)
            elif color.get(m) == 1:
                i = stack_path.index(m)
                cyc = stack_path[i:] + [m]
                cycles.append(cyc)
        stack_path.pop()
        color[n] = 2

    for n in sorted(ctx.graph):
        if color.get(n, 0) == 0:
            dfs(n)
    seen_cycles = set()
    for cyc in cycles:
        key = frozenset(cyc)
        if key in seen_cycles:
            continue
        seen_cycles.add(key)
        a, b = cyc[0], cyc[1]
        file, line = ctx.graph[a][b]
        ctx.findings.append(Finding(
            "lock-order", file, line,
            "lock acquisition cycle (potential deadlock): "
            + " -> ".join(cyc)))

    # ---- phase 5: mixed-guard unguarded writes
    lock_owning = {name.split(".")[0] for name in ctx.locks
                   if "." in name}
    audited = (lock_owning & ctx.known_classes) | (
        set(cfg.concurrent_classes) & ctx.known_classes)
    # inherited guards: a private helper only ever called under a lock
    # inherits that guard at its call sites
    inherited: dict[tuple, frozenset] = {}
    init_only: set[tuple] = set()
    # fixpoint over a few rounds so guards propagate through helper
    # chains (pick → _group_locked → _add_group)
    for _round in range(4):
        call_sites: dict[tuple, list] = {}
        for key, info in ctx.methods.items():
            caller_key = (info.cls, info.name)
            inh = inherited.get(caller_key, frozenset())
            for held, callee, _line in info.calls:
                if callee[0] and callee[0] == info.cls:
                    call_sites.setdefault(callee, []).append(
                        (info.name, frozenset(held) | inh,
                         caller_key in init_only))
        changed = False
        for key, sites in call_sites.items():
            cls, name = key
            if not name.startswith("_"):
                continue
            # construction is single-threaded: an __init__ call site is
            # not evidence of an unguarded concurrent path
            concurrent_sites = [
                h for caller, h, caller_init in sites
                if caller not in ("__init__", "__post_init__")
                and not caller_init]
            if concurrent_sites:
                guard = frozenset.intersection(*concurrent_sites)
                if guard and inherited.get(key) != guard:
                    inherited[key] = guard
                    changed = True
            elif sites and key not in init_only:
                # only ever called during construction: everything it
                # writes is pre-publication
                init_only.add(key)
                changed = True
        if not changed:
            break

    lock_attr_names = {name.split(".", 1)[1] for name in ctx.locks
                       if "." in name}
    writes_by_attr: dict[tuple, list] = {}
    for key, info in ctx.methods.items():
        if info.cls not in audited:
            continue
        if info.name in ("__init__", "__post_init__", "__del__",
                         "__enter__"):
            continue
        if (info.cls, info.name) in init_only:
            continue  # construction helpers write pre-publication state
        inh = inherited.get((info.cls, info.name), frozenset())
        for attr, sites in info.writes.items():
            if attr in lock_attr_names:
                continue  # installing/replacing the lock object itself
            for held, line in sites:
                guards = frozenset(held) | inh
                writes_by_attr.setdefault((info.cls, attr), []).append(
                    (guards, info.file, line, info.name))
    for (cls, attr), sites in sorted(writes_by_attr.items()):
        guarded = [s for s in sites if s[0]]
        bare = [s for s in sites if not s[0]]
        if not guarded or not bare:
            continue
        lock_names = sorted({ln for s in guarded for ln in s[0]})
        for _g, file, line, meth in bare:
            ctx.findings.append(Finding(
                "lock-unguarded", file, line,
                f"{cls}.{attr} is written under {'/'.join(lock_names)} "
                f"elsewhere but bare here (in {meth}) — racy "
                "read-modify-write or torn publish"))

    return ctx.findings
