"""Rule ``host-sync``: no host read inside captured code.

The port's dispatch story (a decode block is one CUDA-graph replay and one
fetch: at most 2 host ops a fused block) holds only while nothing inside
a captured program reads a device value on the host. On the card such a
read fails the capture; on the CPU, where the same bodies run eagerly, it
passes silently and costs a sync per step on every path the tests do not
drive. This rule flags the class statically inside every captured scope
(:mod:`.tracing`: functions handed to ``CapturedProgram``, ``with
torch.cuda.graph`` bodies, and the same-class methods they reach through
``self.`` calls):

* unconditional sinks: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.synchronize()`` / ``torch.cuda.synchronize()``,
  ``.to("cpu")``, ``np.asarray`` / ``np.array`` (host materialization),
  ``print``;
* tainted sinks, only when fed a device value: ``float()`` / ``int()`` /
  ``bool()`` coercion and Python control flow (``if`` / ``while`` /
  ``for`` / ``assert`` over a device value). Branching on configuration
  (``if tables is not None:``, ``if self.lora:``) stays legal.

The taint has two levels (:class:`_Taint`). Objects: ``self``, closure
variables, a delegate method's parameters, and names bound from their
attributes (``lm, state = self.lm, self.state``; ``f = st.dev_field``);
branching on them or on their attributes is configuration. Device values:
a program's parameters without defaults (its inputs are tensors; defaulted
parameters are configuration, as JAX's ``static_argnums`` are),
``torch.*`` results, the result of calling an object's method or a tainted
callable (``f("done")``), and anything computed from a device value. Only
device values feed the tainted sinks. ``.shape`` / ``.dtype`` / ``.ndim``
/ ``.device`` projections, ``.size()`` / ``.dim()`` / ``.numel()``,
``len()``, ``isinstance()`` and ``is`` / ``is not`` comparisons are static
and sanitize; a dict's ``.items()`` / ``.keys()`` / ``.values()`` is a
host container (an object).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Set

from .core import Finding, FileCtx, RepoCtx, Rule
from .tracing import Index, ScopeNode, _dotted, captured_scopes, roots

# attribute calls that read a device value on the host wherever they appear
SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
# dotted callables that materialize on the host or wait for the device
SYNC_CALLS = {
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "torch.cuda.synchronize",
}
COERCIONS = {"float", "int", "bool", "complex"}
# projections that are static: reading them is no sync and no taint
SAFE_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout"}
SAFE_METHODS = {"size", "dim", "numel", "is_contiguous", "element_size",
                "data_ptr", "get_device"}
SAFE_CALLS = {"len", "isinstance", "callable", "hasattr", "getattr", "id", "type"}
# host container views (a dict of tensors): iterating them reads no device
CONTAINER_METHODS = {"items", "keys", "values"}
# torch callables whose results are no device values
TORCH_STATIC_LEAVES = {
    "device", "dtype", "Size", "is_tensor", "is_floating_point", "is_complex",
    "is_grad_enabled", "no_grad", "enable_grad", "inference_mode",
    "set_grad_enabled", "finfo", "iinfo", "get_default_dtype", "Generator",
}
TORCH_STATIC_MODULES = {"cuda", "backends", "distributed", "_C", "utils", "library",
                        "autograd", "jit", "compiler", "testing"}


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device("cpu"))``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    vals = list(call.args) + [k.value for k in call.keywords if k.arg == "device"]
    for v in vals:
        if isinstance(v, ast.Constant) and v.value == "cpu":
            return True
        if (isinstance(v, ast.Call) and _dotted(v.func) == "torch.device" and v.args
                and isinstance(v.args[0], ast.Constant) and v.args[0].value == "cpu"):
            return True
    return False


def _torch_tensor_call(call: ast.Call) -> bool:
    d = _dotted(call.func)
    if not d.startswith("torch."):
        return False
    parts = d.split(".")
    return parts[1] not in TORCH_STATIC_MODULES and parts[-1] not in TORCH_STATIC_LEAVES


def _bound_names(fn: ast.AST) -> Set[str]:
    """Names a scope binds itself: its parameters and every store in it."""
    out: Set[str] = set()
    if isinstance(fn, ScopeNode):
        a = fn.args
        out |= {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
        out |= {p.arg for p in (a.vararg, a.kwarg) if p is not None}
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


CLEAN, OBJ, DEVICE = 0, 1, 2


class _Taint:
    """Flow-insensitive taint inside one captured scope, on two levels:

    * ``OBJ``: an object a captured body reads state through (``self``,
      closure variables, names bound from their attributes, a delegate's
      parameters): branching on it, or on its attributes, is configuration;
    * ``DEVICE``: a device value: a program's parameters, ``torch.*``
      results, the result of calling an object's method or a tainted
      callable (``f("done")`` where ``f = st.dev_field``), and anything
      computed from a device value.

    Sinks fire on ``DEVICE`` only. Deliberately simple: false negatives
    are acceptable, false positives on configuration branching are not."""

    def __init__(self, fn: ast.AST, closure: Set[str], device_params: bool):
        self.kinds: Dict[str, int] = {name: OBJ for name in closure}
        if isinstance(fn, ScopeNode):
            a = fn.args
            pos = a.posonlyargs + a.args
            undefaulted = pos[:len(pos) - len(a.defaults)]
            undefaulted += [p for p, d in zip(a.kwonlyargs, a.kw_defaults) if d is None]
            for p in undefaulted:
                self.kinds[p.arg] = DEVICE if device_params else OBJ
            for p in pos[:1]:
                if p.arg in ("self", "cls"):
                    self.kinds[p.arg] = OBJ
        assigns = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (isinstance(t, ast.Tuple) and isinstance(node.value, ast.Tuple)
                            and len(t.elts) == len(node.value.elts)):
                        assigns.extend(zip(t.elts, node.value.elts))
                    else:
                        assigns.append((t, node.value))
            elif isinstance(node, (ast.AugAssign, ast.NamedExpr)):
                assigns.append((node.target, node.value))
            elif isinstance(node, ast.For):
                assigns.append((node.target, node.iter))
        changed = True
        while changed:
            changed = False
            for tgt, value in assigns:
                k = self.kind(value)
                if k:
                    changed |= self._bind(tgt, k)

    def _bind(self, tgt: ast.AST, k: int) -> bool:
        """Raise the names a target binds to ``k`` (a store into ``x[i]``
        or ``x.a`` binds no name)."""
        if isinstance(tgt, ast.Name):
            if self.kinds.get(tgt.id, CLEAN) >= k:
                return False
            self.kinds[tgt.id] = k
            return True
        if isinstance(tgt, (ast.Tuple, ast.List)):
            return any([self._bind(e, k) for e in tgt.elts])
        if isinstance(tgt, ast.Starred):
            return self._bind(tgt.value, k)
        return False

    def kind(self, node: ast.AST) -> int:
        if isinstance(node, ast.Name):
            return self.kinds.get(node.id, CLEAN)
        if isinstance(node, ast.Attribute):
            return CLEAN if node.attr in SAFE_ATTRS else self.kind(node.value)
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return CLEAN
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d in SAFE_CALLS or (isinstance(node.func, ast.Attribute)
                                   and node.func.attr in SAFE_METHODS):
                return CLEAN
            if d.startswith("torch."):
                return DEVICE if _torch_tensor_call(node) else CLEAN
            if isinstance(node.func, ast.Attribute) and node.func.attr in CONTAINER_METHODS:
                return min(self.kind(node.func.value), OBJ)
            if self.kind(node.func):
                return DEVICE
            args = list(node.args) + [k.value for k in node.keywords]
            return max((self.kind(a) for a in args), default=CLEAN)
        if isinstance(node, ScopeNode):
            return CLEAN
        return max((self.kind(c) for c in ast.iter_child_nodes(node)), default=CLEAN)

    def device(self, node: ast.AST) -> bool:
        return self.kind(node) == DEVICE


def _sinks(fc: FileCtx, fn: ast.AST, taint: _Taint, nodes) -> Iterator[Finding]:
    for node in nodes:
        if isinstance(node, ast.Call):
            dotted = _dotted(node.func)
            if dotted in SYNC_CALLS:
                yield Finding(
                    "host-sync", fc.rel, node.lineno, fc.qualname_at(node),
                    f"{dotted}() inside captured code waits for or copies from "
                    f"the device")
            elif isinstance(node.func, ast.Attribute) and node.func.attr in SYNC_ATTRS:
                yield Finding(
                    "host-sync", fc.rel, node.lineno, fc.qualname_at(node),
                    f".{node.func.attr}() inside captured code reads the device "
                    f"on the host (a capture refuses it; eagerly it syncs per step)")
            elif _to_cpu(node):
                yield Finding(
                    "host-sync", fc.rel, node.lineno, fc.qualname_at(node),
                    ".to('cpu') inside captured code copies to the host")
            elif dotted == "print":
                yield Finding(
                    "host-sync", fc.rel, node.lineno, fc.qualname_at(node),
                    "print() inside captured code (it formats device values "
                    "on the host)")
            elif (dotted in COERCIONS and node.args
                  and not isinstance(node.args[0], ast.Constant)
                  and taint.device(node.args[0])):
                yield Finding(
                    "host-sync", fc.rel, node.lineno, fc.qualname_at(node),
                    f"{dotted}() coercion of a device value inside captured code")
        elif isinstance(node, (ast.If, ast.While)):
            if taint.device(node.test):
                yield Finding(
                    "host-sync", fc.rel, node.lineno, fc.qualname_at(node),
                    "Python-side branch on a device value inside captured code "
                    "(use torch.where)")
        elif isinstance(node, ast.For):
            if taint.device(node.iter):
                yield Finding(
                    "host-sync", fc.rel, node.lineno, fc.qualname_at(node),
                    "Python-side iteration over a device value inside captured code")
        elif isinstance(node, ast.Assert):
            if taint.device(node.test):
                yield Finding(
                    "host-sync", fc.rel, node.lineno, fc.qualname_at(node),
                    "assert on a device value inside captured code syncs")


def _closure(ix: Index, fn: ast.AST) -> Set[str]:
    """Names ``fn`` reads from its enclosing functions (not its globals)."""
    out: Set[str] = set()
    scope = ix.parent_scope.get(id(fn))
    while isinstance(scope, ScopeNode):
        out |= _bound_names(scope)
        scope = ix.parent_scope.get(id(scope))
    return out - (_bound_names(fn) if isinstance(fn, ScopeNode) else set())


def _check_file(fc: FileCtx) -> Iterator[Finding]:
    if "CapturedProgram" not in fc.source and "cuda.graph" not in fc.source:
        return
    ix = Index(fc.tree)
    for info in roots(captured_scopes(fc.tree, ix)):
        fn = info["node"]
        if isinstance(fn, ScopeNode):
            taint = _Taint(fn, _closure(ix, fn), device_params=info["kind"] != "delegate")
            yield from _sinks(fc, fn, taint, fc.walk(fn))
        else:   # a `with torch.cuda.graph(...)` body, in its function's terms
            owner = ix.function_of(fn)
            scope = owner if owner is not None else fn
            taint = _Taint(scope, _closure(ix, scope), device_params=False)
            yield from _sinks(fc, fn, taint, [n for stmt in fn.body for n in fc.walk(stmt)])


def check(ctx: RepoCtx) -> Iterator[Finding]:
    for fc in ctx.checked_files():
        yield from _check_file(fc)


RULE = Rule(
    id="host-sync",
    doc="no host reads or Python branching on device values inside captured "
        "programs (CapturedProgram bodies, torch.cuda.graph blocks, and the "
        "same-class methods they call)",
    check=check,
    zero_waiver=True,
)
