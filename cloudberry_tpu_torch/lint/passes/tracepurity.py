"""Trace-purity pass — host-side escapes inside jitted/kernel functions.

A function body that executes UNDER TRACE (jax.jit, shard_map, a Pallas
kernel) must stay on-device: ``np.*`` on a traced value silently falls
back to host numpy (wrong under jit — it either fails on tracers or
constant-folds stale data), ``.item()``/``float()``/``int()`` coercions
force a concretization error, Python ``if``/``while`` on a tracer raises
``TracerBoolConversionError`` at runtime, and f32 accumulation of
int64/DECIMAL values silently rounds past 2^24 unless it rides the limb
convention (exact grouped aggregation).

Kernel scope — in config.KERNEL_MODULES only:

- functions decorated with ``jax.jit`` (incl. ``functools.partial``);
- functions passed BY NAME to ``jax.jit(...)`` / ``_shard_map(...)`` /
  ``pl.pallas_call(...)`` in the same module;
- Pallas kernels (name ends with ``_kernel``).

Rules: ``purity-host-np``, ``purity-coerce``, ``purity-branch``,
``purity-f32-accum``.
"""

from __future__ import annotations

import ast

from cloudberry_tpu_torch.lint.core import Finding

# np.* calls that are trace-legal (shape/dtype metadata, not data)
_NP_META_OK = frozenset({
    "dtype", "shape", "ndim", "iinfo", "finfo", "result_type",
    "promote_types", "can_cast", "issubdtype", "sctype2char",
    # dtype constructors used as static arguments
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "bool_", "integer",
    "floating", "number", "generic", "signedinteger", "unsignedinteger",
})

_TRACED_JIT_CALLS = ("jit", "pallas_call", "shard_map", "_shard_map",
                     "pjit", "vmap", "pmap")


def _is_jit_decorator(dec: ast.AST) -> bool:
    """@jax.jit / @jit / @functools.partial(jax.jit, ...)."""

    def names(n: ast.AST) -> str:
        if isinstance(n, ast.Attribute):
            return n.attr
        if isinstance(n, ast.Name):
            return n.id
        return ""

    if names(dec) == "jit":
        return True
    if isinstance(dec, ast.Call):
        if names(dec.func) == "jit":
            return True
        if names(dec.func) == "partial" and dec.args \
                and names(dec.args[0]) == "jit":
            return True
    return False


def _collect_kernel_funcs(tree: ast.Module) -> dict[str, ast.FunctionDef]:
    """name -> FunctionDef for every function in kernel scope, at any
    nesting depth (tiled executors define step_fn inside methods)."""
    all_funcs: dict[str, list[ast.FunctionDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            all_funcs.setdefault(node.name, []).append(node)

    kernel: dict[str, ast.FunctionDef] = {}
    for name, defs in all_funcs.items():
        for fn in defs:
            if name.endswith("_kernel"):
                kernel[name] = fn
            elif any(_is_jit_decorator(d) for d in fn.decorator_list):
                kernel[name] = fn
    # functions passed by name into jit/pallas_call/shard_map
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fname = node.func.attr if isinstance(node.func, ast.Attribute) \
            else (node.func.id if isinstance(node.func, ast.Name) else "")
        if fname not in _TRACED_JIT_CALLS:
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Name) and arg.id in all_funcs:
                for fn in all_funcs[arg.id]:
                    kernel[arg.id] = fn
    return kernel


def _const_args_only(call: ast.Call) -> bool:
    return all(isinstance(a, (ast.Constant, ast.UnaryOp))
               for a in call.args)


def _expr_text(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:
        return ""


class _PurityWalker(ast.NodeVisitor):
    def __init__(self, file: str, fn: ast.FunctionDef, limb_ok: bool,
                 findings: list):
        self.file = file
        self.fn = fn
        self.limb_ok = limb_ok
        self.findings = findings
        # static/config parameters (keyword-only or *, defaults of int)
        # are python values — int()/float() on them is fine
        self.static_names = {a.arg for a in fn.args.kwonlyargs}

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        # np.something(...) on traced values
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in ("np", "numpy") \
                and f.attr not in _NP_META_OK:
            self.findings.append(Finding(
                "purity-host-np", self.file, node.lineno,
                f"host-side numpy call np.{f.attr}(...) inside traced "
                f"function {self.fn.name!r} — use jnp (np falls off the "
                "device and breaks under jit)"))
        # .item() concretization
        if isinstance(f, ast.Attribute) and f.attr in ("item", "tolist"):
            self.findings.append(Finding(
                "purity-coerce", self.file, node.lineno,
                f".{f.attr}() inside traced function {self.fn.name!r} "
                "forces a device→host concretization "
                "(TracerArrayConversionError under jit)"))
        # float(x)/int(x)/bool(x) on non-literal args
        if isinstance(f, ast.Name) and f.id in ("float", "int", "bool") \
                and node.args and not _const_args_only(node):
            arg = node.args[0]
            if not (isinstance(arg, ast.Name)
                    and arg.id in self.static_names):
                self.findings.append(Finding(
                    "purity-coerce", self.file, node.lineno,
                    f"{f.id}(...) coercion inside traced function "
                    f"{self.fn.name!r} concretizes a traced value; use "
                    f"jnp casts (x.astype) or mark the arg static"))
        self.generic_visit(node)

    def _test_is_traced(self, test: ast.AST) -> bool:
        """A branch test that CALLS jnp (jnp.any(x) > 0, jnp.all(...))
        is branching on a tracer — the one form we can prove statically."""
        for sub in ast.walk(test):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id == "jnp":
                return True
        return False

    def visit_If(self, node: ast.If) -> None:
        if self._test_is_traced(node.test):
            self.findings.append(Finding(
                "purity-branch", self.file, node.lineno,
                f"Python branch on a jnp expression inside traced "
                f"function {self.fn.name!r} — use jnp.where / lax.cond "
                "(a tracer has no truth value)"))
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        if self._test_is_traced(node.test):
            self.findings.append(Finding(
                "purity-branch", self.file, node.lineno,
                f"Python while-loop on a jnp expression inside traced "
                f"function {self.fn.name!r} — use lax.while_loop"))
        self.generic_visit(node)

    def check_f32_accum(self) -> None:
        if self.limb_ok:
            return
        for node in ast.walk(self.fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            # x.astype(jnp.float32) where x mentions int64/i64
            if isinstance(f, ast.Attribute) and f.attr == "astype" \
                    and node.args:
                dst = _expr_text(node.args[0])
                src = _expr_text(f.value)
                if dst.endswith(("float32", "f32")) and any(
                        m in src for m in ("int64", "i64")):
                    self.findings.append(Finding(
                        "purity-f32-accum", self.file, node.lineno,
                        f"int64 value cast to f32 inside traced function "
                        f"{self.fn.name!r} outside the limb convention — "
                        "sums silently round past 2^24 (use the 13-bit "
                        "limb path, kernels group_layout)"))
            # jnp.sum(..., dtype=jnp.float32) over an int64 expression
            if isinstance(f, ast.Attribute) \
                    and f.attr in ("sum", "cumsum") :
                for kw in node.keywords:
                    if kw.arg == "dtype" \
                            and _expr_text(kw.value).endswith("float32"):
                        args_text = " ".join(
                            _expr_text(a) for a in node.args)
                        if any(m in args_text for m in ("int64", "i64")):
                            self.findings.append(Finding(
                                "purity-f32-accum", self.file,
                                node.lineno,
                                "f32-dtype reduction over an int64 "
                                f"expression in {self.fn.name!r} — "
                                "exactness requires the limb path"))


def run(modules, cfg) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        if not any(mod.relpath.endswith(k) for k in cfg.kernel_modules):
            continue
        kernels = _collect_kernel_funcs(mod.tree)
        for name, fn in sorted(kernels.items()):
            limb_ok = any(m in name.lower()
                          for m in cfg.limb_func_markers)
            w = _PurityWalker(mod.relpath, fn, limb_ok, findings)
            for stmt in fn.body:
                w.visit(stmt)
            w.check_f32_accum()
    return findings
