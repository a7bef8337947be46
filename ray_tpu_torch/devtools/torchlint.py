"""torchlint — the torch-aware raylint checks (static half of the host-sync
and compile-churn tier; ``ray_tpu_torch.devtools.jitcheck`` is the runtime
half).

The port's twin of ``ray_tpu/devtools/jaxlint.py``. raylint
(``ray_tpu_torch.devtools.lint``) covers locks, RPC contracts and resource
lifecycles but is blind to the tensor side of the tree, where the costly
mistakes are invisible to every functional test: one stray ``.item()`` in
the decode loop serializes the card's stream with the host, and a
``torch.compile`` built per call recompiles every time. These checks run as
extra phases inside :class:`ray_tpu_torch.devtools.lint.Linter` — same AST
cache, same ``# raylint: ignore[...]`` pragmas, same fingerprint/baseline
machinery, same ``ray-tpu-torch-lint`` CLI and tier-1 gate.

Checks
======
``host-sync``
    Inside the declared hot-path scopes (:data:`HOT_SCOPES` — the engine
    step/decode path, the token generator, the RL sample/update/inference
    loops; coverage-guarded so a rename can't silently retire a scope), any
    implicit device→host read of a value the intra-function taint walk
    proves is a tensor: ``.item()`` / ``.tolist()``, ``float()`` /
    ``int()`` / ``bool()`` coercion, ``__index__`` use (a tensor as a
    slice bound or a ``range`` length), truthiness tests, and ``.cpu()`` /
    ``.numpy()`` / ``np.asarray``. Taint comes from ``torch.*`` calls
    other than the host-safe ones, tensor methods on a tainted value,
    :data:`DEVICE_FN_NAMES` calls, and calls of a function or method with a
    tainted argument (torch has no jit boundary: a helper handed tensors
    hands tensors back). The sanctioned exit is an EXPLICIT
    ``jitcheck.device_get`` — its result is a host value and untainted, as
    the runtime guard counts it.
``compile-churn``
    A ``torch.compile(...)`` / ``functools.partial(torch.compile, ...)``
    built in FUNCTION scope (so: re-executed per call) whose result neither
    escapes (returned / yielded — the one-shot factory), nor is cached (on
    ``self.`` / a container slot), nor is handed to another call. Each call
    of the enclosing function then pays a fresh Dynamo trace and Inductor
    compile. The port has no ``torch.compile`` today: the check guards
    against one arriving in a per-call path.

JAX's ``key-reuse``, ``donate-uaf`` and ``jit-churn``'s static-argument
half have no torch counterpart: a ``torch.Generator`` advances on every
draw, ``donate`` is accepted and does nothing in the port, and
``torch.compile`` has no static-argument positions.

All findings fingerprint without line numbers (baseline-stable) and obey
the standard pragma on the finding line or the comment lines above it.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.devtools.lint import Finding

__all__ = ["TORCH_CHECKS", "HOT_SCOPES", "DEVICE_FN_NAMES",
           "check_host_sync", "check_compile_churn"]

TORCH_CHECKS = ("host-sync", "compile-churn")

#: The hot-path scopes host-sync patrols: scan-root-relative path suffix →
#: function/method names that constitute the per-step / per-token path.
#: Coverage-guarded: when the file is in the scan set, every named scope
#: must exist, so a rename retires the declaration loudly, not silently.
#: The JAX package's table with one remap: the port's inference actor
#: serves each runner's step through ``infer`` (no batching thread); and
#: one addition, the port's own bias-GELU kernel wrapper, which runs in
#: every layer of every train step and serving forward.
HOT_SCOPES: Dict[str, Tuple[str, ...]] = {
    "serve/llm.py": ("_step_inner", "_run_decode"),
    "models/generate.py": ("generate",),
    "rllib/env_runner.py": ("sample",),
    "rllib/learner.py": ("update",),
    "rllib/inference.py": ("infer",),
    "ops/bias_gelu.py": ("linear_gelu", "forward", "backward",
                         "_forward_cuda", "_backward_cuda", "_splits"),
}

#: Method names whose call results are tensors wherever they appear (the
#: model forward surface used by the RL stack).
DEVICE_FN_NAMES = {"forward_inference", "forward_train", "sample_action",
                   "sample_with_noise", "init_params"}

#: torch.* calls (and prefixes) that return HOST values, never tensors.
_TORCH_HOST_SAFE = {
    "torch.get_default_dtype", "torch.device", "torch.Size", "torch.finfo",
    "torch.iinfo", "torch.is_tensor", "torch.is_grad_enabled",
    "torch.no_grad", "torch.inference_mode", "torch.enable_grad",
    "torch.set_grad_enabled", "torch.manual_seed", "torch.Generator",
    "torch.get_num_threads", "torch.set_num_threads", "torch.autocast",
    "torch.is_floating_point", "torch.compile",
}
_TORCH_HOST_SAFE_PREFIXES = ("torch.cuda.", "torch.backends.",
                             "torch.profiler.", "torch.autograd.profiler.",
                             "torch.distributed.")

_NP_SYNC_CALLS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}

#: builtins and host modules whose results are host values even when handed
#: a tensor (the coercions among them are sinks, flagged separately)
_HOST_CALLS = {
    "len", "int", "float", "bool", "complex", "str", "repr", "print",
    "isinstance", "type", "id", "range", "list", "tuple", "dict", "set",
    "zip", "enumerate", "sorted", "reversed", "min", "max", "sum", "abs",
    "round", "any", "all", "iter", "next", "hash", "getattr", "hasattr",
    "setattr", "map", "filter", "divmod",
}
_HOST_MODULE_PREFIXES = ("np.", "numpy.", "math.", "time.", "jitcheck.",
                         "logger.", "logging.", "log.", "tracing.",
                         "flightrec.", "metrics.")

#: tensor methods and attributes that read metadata the host already holds
_META_METHODS = {"size", "dim", "numel", "nelement", "stride",
                 "element_size", "data_ptr", "get_device", "is_contiguous",
                 "is_floating_point", "storage_offset", "__len__"}
_META_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "nbytes",
               "itemsize", "layout", "requires_grad", "is_leaf"}

#: reads that hand a tensor's value to the host: .kind() -> finding detail
_READ_METHODS = {"item": "item:item", "tolist": "item:tolist",
                 "cpu": "copy:cpu", "numpy": "copy:numpy"}


def _dotted(node: ast.expr) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_torch_compile(node: ast.expr) -> bool:
    """node is the callable ``torch.compile``."""
    return _dotted(node) == "torch.compile"


def _compile_call(node: ast.expr) -> Optional[ast.Call]:
    """The ``torch.compile(...)`` call if node is one, directly or through
    ``functools.partial(torch.compile, ...)``."""
    if not isinstance(node, ast.Call):
        return None
    if _is_torch_compile(node.func):
        return node
    d = _dotted(node.func)
    if d in ("partial", "functools.partial") and node.args \
            and _is_torch_compile(node.args[0]):
        return node
    return None


def _walk_functions(tree: ast.Module):
    """Yield (qualname, func_node, at_module_level) for every function/
    method, in source order, including nested defs."""
    def rec(node, prefix: str, module_level: bool):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}.{child.name}" if prefix else child.name
                yield q, child, module_level
                yield from rec(child, q, False)
            elif isinstance(child, ast.ClassDef):
                q = f"{prefix}.{child.name}" if prefix else child.name
                yield from rec(child, q, module_level)
    yield from rec(tree, "", True)


# ---------------------------------------------------------------------------
# compile-churn
# ---------------------------------------------------------------------------


def check_compile_churn(linter,
                        parsed: Sequence[Tuple[str, ast.Module, str]]) -> None:
    for rel, tree, src in parsed:
        if "torch.compile" not in src:
            continue  # nothing to find: skip the per-function walks
        for qual, fn, _mod in _walk_functions(tree):
            _compile_churn_in_function(linter, rel, qual, fn)


def _compile_churn_in_function(linter, rel: str, qual: str, fn) -> None:
    """Per-call torch.compile constructions inside ``fn`` whose result
    never escapes."""
    # name → construction line for local `n = torch.compile(...)` bindings
    local: Dict[str, int] = {}
    escaped: Set[str] = set()
    nested_defs = {c for c in ast.walk(fn)
                   if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and c is not fn}

    def in_nested(node) -> bool:
        return any(node in ast.walk(d) for d in nested_defs)

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            call = _compile_call(node.value)
            if call is None:
                continue
            tgt = node.targets[0] if len(node.targets) == 1 else None
            if isinstance(tgt, ast.Name) and not in_nested(node):
                local[tgt.id] = node.lineno
            # self.x = torch.compile(...) / cache[k] = torch.compile(...):
            # cached.
        elif isinstance(node, ast.Call):
            inner = _compile_call(node.func)
            if inner is not None:
                # torch.compile(f)(args): compiled and thrown away, every call
                what = inner.args[0] if inner.args else None
                name = ((_dotted(what.func) if isinstance(what, ast.Call)
                         else _dotted(what)) if what is not None else None)
                linter.add(Finding(
                    "compile-churn", rel, node.lineno, qual,
                    "torch.compile(...) built and called in one expression"
                    " — a fresh Dynamo trace and compile on every call of"
                    " this function; cache the compiled callable",
                    f"immediate-compile-call:{name or '?'}"))
            # name escaping into another call exempts it
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(arg, ast.Name) and arg.id in local:
                    escaped.add(arg.id)
        elif isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            val = node.value
            if val is None:
                continue
            if _compile_call(val) is not None:
                continue  # `return torch.compile(...)`: the one-shot factory
            # a name escapes if returned ITSELF; `return [fwd(x) ...]`
            # only returns call results — fwd still dies with the frame
            func_pos = {id(sub.func) for sub in ast.walk(val)
                        if isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)}
            for sub in ast.walk(val):
                if isinstance(sub, ast.Name) and sub.id in local \
                        and id(sub) not in func_pos:
                    escaped.add(sub.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            for dec in node.decorator_list:
                if _is_torch_compile(dec) or _compile_call(dec) is not None:
                    local[node.name] = node.lineno

    # names stored into attributes / subscripts (caches) also escape
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    for sub in ast.walk(node.value):
                        if isinstance(sub, ast.Name) and sub.id in local:
                            escaped.add(sub.id)

    for name, line in sorted(local.items(), key=lambda kv: kv[1]):
        if name in escaped:
            continue
        linter.add(Finding(
            "compile-churn", rel, line, qual,
            f"'{name}' rebuilds torch.compile on every call of this function"
            " (the compiled graph dies with the binding); cache it on"
            " self/module or return it from a factory",
            f"local-compile:{name}"))


# ---------------------------------------------------------------------------
# host-sync
# ---------------------------------------------------------------------------


class _TaintWalk:
    """Linear taint walk over one hot function: which bindings hold
    tensors, and where their values leak to the host implicitly. Loops are
    walked twice so cross-iteration flows surface; findings dedupe on
    (line, kind)."""

    def __init__(self, linter, rel: str, qual: str,
                 device_methods: Optional[Set[str]] = None):
        self.linter = linter
        self.rel = rel
        self.qual = qual
        self.taints: Set[str] = set()
        self.compiled_names: Set[str] = set()
        self.seen: Set[Tuple[int, str]] = set()
        #: self-method names whose results are tensors: the file's other
        #: hot scopes (`self._run_decode(...)`) plus every attr the class
        #: caches a torch.compile under
        self.device_methods = device_methods or set()

    # -- tokens -------------------------------------------------------------

    @staticmethod
    def _token(node: ast.expr) -> Optional[str]:
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                          ast.Name) \
                and node.value.id == "self":
            return f"self.{node.attr}"
        return None

    # -- taint evaluation ---------------------------------------------------

    def tainted(self, node: Optional[ast.expr]) -> bool:
        if node is None:
            return False
        tok = self._token(node)
        if tok is not None:
            return tok in self.taints
        if isinstance(node, ast.Call):
            return self._call_taints(node)
        if isinstance(node, ast.Attribute):
            # tensor metadata is host-resident — reading it never syncs
            if node.attr in _META_ATTRS:
                return False
            return self.tainted(node.value)
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self.tainted(node.value)
        if isinstance(node, ast.BinOp):
            return self.tainted(node.left) or self.tainted(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tainted(node.operand)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False  # identity never reads the value
            return self.tainted(node.left) or any(
                self.tainted(c) for c in node.comparators)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tainted(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.tainted(node.body) or self.tainted(node.orelse)
        if isinstance(node, ast.NamedExpr):
            return self.tainted(node.value)
        return False

    def _args_tainted(self, node: ast.Call) -> bool:
        return any(self.tainted(a) for a in node.args) or any(
            self.tainted(k.value) for k in node.keywords)

    def _call_taints(self, node: ast.Call) -> bool:
        d = _dotted(node.func)
        if d is not None:
            if d.rsplit(".", 1)[-1] == "device_get":
                return False  # the sanctioned read: host values
            if d in _NP_SYNC_CALLS or d in _HOST_CALLS \
                    or d.startswith(_HOST_MODULE_PREFIXES):
                return False
            if d.startswith("torch."):
                return not (d in _TORCH_HOST_SAFE
                            or d.startswith(_TORCH_HOST_SAFE_PREFIXES))
        if isinstance(node.func, ast.Name) and (
                node.func.id in self.compiled_names
                or node.func.id in self.taints):
            return True
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in DEVICE_FN_NAMES:
                return True
            if attr in self.device_methods and isinstance(
                    node.func.value, ast.Name) \
                    and node.func.value.id == "self":
                return True
            if attr in _READ_METHODS or attr in _META_METHODS:
                return False  # host values (the reads flagged as sinks)
            # method call on a tensor stays a tensor
            if self.tainted(node.func.value):
                return True
        elif isinstance(node.func, ast.Subscript):
            if self.tainted(node.func.value):
                return True
        # tensors in, tensors out: a helper handed a tensor hands one back
        return self._args_tainted(node)

    # -- findings -----------------------------------------------------------

    def _emit(self, line: int, kind: str, message: str) -> None:
        if (line, kind) in self.seen:
            return
        self.seen.add((line, kind))
        self.linter.add(Finding("host-sync", self.rel, line, self.qual,
                                message, kind))

    def _index_sink(self, node: ast.expr) -> None:
        if node is not None and self.tainted(node):
            self._emit(node.lineno, "index",
                       "a tensor used as a Python index (__index__) inside"
                       " a hot scope syncs the stream; device_get it first")

    def check_sinks(self, expr: Optional[ast.expr]) -> None:
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                if d in _NP_SYNC_CALLS and node.args \
                        and self.tainted(node.args[0]):
                    self._emit(node.lineno, f"np-sync:{d}",
                               f"{d}() on a tensor inside a hot scope — an"
                               " implicit blocking read; batch into one"
                               " jitcheck.device_get per step")
                elif d in ("float", "int", "bool", "complex") and node.args \
                        and self.tainted(node.args[0]):
                    self._emit(node.lineno, f"coerce:{d}",
                               f"{d}() coercion of a tensor inside a hot"
                               " scope syncs the stream; device_get once,"
                               " then coerce on host")
                elif d == "range":
                    for a in node.args:
                        self._index_sink(a)
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _READ_METHODS \
                        and self.tainted(node.func.value):
                    self._emit(node.lineno, _READ_METHODS[node.func.attr],
                               f".{node.func.attr}() on a tensor inside a"
                               " hot scope reads it on the host; device_get"
                               " once, then read on host")
            elif isinstance(node, ast.Slice):
                for bound in (node.lower, node.upper, node.step):
                    self._index_sink(bound)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                self._comprehension(node)

    def _comprehension(self, node) -> None:
        added: List[str] = []
        for gen in node.generators:
            if self.tainted(gen.iter):
                for sub in ast.walk(gen.target):
                    tok = self._token(sub)
                    if tok and tok not in self.taints:
                        self.taints.add(tok)
                        added.append(tok)
            for cond in gen.ifs:
                self.truthiness(cond)
        if isinstance(node, ast.DictComp):
            self.check_sinks(node.key)
            self.check_sinks(node.value)
        else:
            self.check_sinks(node.elt)
        for tok in added:
            self.taints.discard(tok)

    def truthiness(self, test: ast.expr) -> None:
        self.check_sinks(test)
        probe = test
        while isinstance(probe, ast.UnaryOp) and isinstance(probe.op,
                                                            ast.Not):
            probe = probe.operand
        if isinstance(probe, ast.BoolOp):
            for v in probe.values:
                self.truthiness(v)
            return
        if self.tainted(probe):
            self._emit(test.lineno, "truthiness",
                       "truthiness test on a tensor inside a hot scope"
                       " forces a blocking read; device_get first")

    # -- statement walk -----------------------------------------------------

    def assign_to(self, target: ast.expr, is_tainted: bool) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self.assign_to(elt, is_tainted)
            return
        if isinstance(target, ast.Starred):
            self.assign_to(target.value, is_tainted)
            return
        tok = self._token(target)
        if tok is None:
            return
        if is_tainted:
            self.taints.add(tok)
        else:
            self.taints.discard(tok)

    def block(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            self.stmt(stmt)

    def stmt(self, s: ast.stmt) -> None:  # noqa: C901 — a dispatch table
        if isinstance(s, ast.Assign):
            self.check_sinks(s.value)
            t = self.tainted(s.value)
            if _compile_call(s.value) is not None and s.targets \
                    and isinstance(s.targets[0], ast.Name):
                self.compiled_names.add(s.targets[0].id)
            for tgt in s.targets:
                self.assign_to(tgt, t)
        elif isinstance(s, ast.AnnAssign) and s.value is not None:
            self.check_sinks(s.value)
            self.assign_to(s.target, self.tainted(s.value))
        elif isinstance(s, ast.AugAssign):
            self.check_sinks(s.value)
            if self.tainted(s.value):
                self.assign_to(s.target, True)
        elif isinstance(s, ast.Expr):
            self.check_sinks(s.value)
        elif isinstance(s, ast.Return):
            self.check_sinks(s.value)
        elif isinstance(s, ast.If):
            self.truthiness(s.test)
            self.block(s.body)
            self.block(s.orelse)
        elif isinstance(s, ast.While):
            for _ in range(2):
                self.truthiness(s.test)
                self.block(s.body)
            self.block(s.orelse)
        elif isinstance(s, ast.For):
            self.check_sinks(s.iter)
            it_tainted = self.tainted(s.iter)
            for _ in range(2):
                self.assign_to(s.target, it_tainted)
                self.block(s.body)
            self.block(s.orelse)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self.check_sinks(item.context_expr)
                if item.optional_vars is not None:
                    self.assign_to(item.optional_vars,
                                   self.tainted(item.context_expr))
            self.block(s.body)
        elif isinstance(s, ast.Try):
            self.block(s.body)
            for h in s.handlers:
                self.block(h.body)
            self.block(s.orelse)
            self.block(s.finalbody)
        elif isinstance(s, ast.Assert):
            self.truthiness(s.test)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def (e.g. the generator closure inside `generate`):
            # walk it with the closure's taint state — per-token reads in
            # the inner loop are exactly what this check is for.
            self.block(s.body)
        # Import/Pass/Break/Continue/Raise/Delete/Global: nothing to taint


def _compile_cache_attrs(tree: ast.Module) -> Set[str]:
    """Attr names the file's classes cache compiled callables under:
    ``self.X = torch.compile(...)`` anywhere."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) \
                and _compile_call(node.value) is not None:
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self":
                    out.add(tgt.attr)
    return out


def check_host_sync(linter,
                    parsed: Sequence[Tuple[str, ast.Module, str]]) -> None:
    for rel, tree, _src in parsed:
        scopes = None
        for key, names in HOT_SCOPES.items():
            if rel == key or rel.endswith("/" + key):
                scopes = set(names)
                break
        if scopes is None:
            continue
        device_methods = scopes | _compile_cache_attrs(tree)
        found: Set[str] = set()
        for qual, fn, _mod in _walk_functions(tree):
            if fn.name not in scopes:
                continue
            found.add(fn.name)
            walk = _TaintWalk(linter, rel, qual, device_methods)
            walk.block(fn.body)
        for missing in sorted(scopes - found):
            linter.add(Finding(
                "host-sync", rel, 1, "<file>",
                f"declared hot scope '{missing}' not found — update"
                " ray_tpu_torch.devtools.torchlint.HOT_SCOPES so the decode"
                " path stays patrolled",
                f"hot-scope-missing:{missing}"))
