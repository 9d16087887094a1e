"""Captured-scope discovery for the host-sync rule.

"Captured" here means the code runs while a CUDA graph records it, so a
host read there either fails the capture or, eagerly on the CPU, hides a
sync the card's replay cannot make. A scope is captured when:

* its function is handed to ``CapturedProgram(fn, ...)``, the port's
  program (``inference/model_builder.py``); or
* its statements run inside ``with torch.cuda.graph(...)``.

The handed function is resolved statically to a ``def`` or a lambda: a
name bound lexically (a nested ``def``, a module function), ``self.<m>``
(a method of the enclosing class), a local bound to one of those or to a
factory call (``body = _build_round_block(...)``: the defs the factory
returns), a loop or comprehension target over literal pairs (``for name,
fn in (("prefill", prefill), ...)``), or a parameter of the enclosing
function (``CausalLM._run(state, signature, body, inputs)``): then the
argument each caller in the same file passes there, resolved at the
caller. Everything lexically inside a captured function runs under the
capture, nested ``def``\\ s included, as in JAX's rule.

The port's bodies delegate where JAX's jitted functions are lexically
whole, so a captured scope's ``self.<m>(...)`` calls are followed to the
methods of the same class, up to :data:`DELEGATION_DEPTH` calls deep (the
resource-pairing rule's delegation limit). Calls on other objects or
modules (``lm._forward`` from ``FusedDecode._body``, ``draw_rows``) are not
chased: an accepted false negative, as JAX accepts closure arrays.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)
ScopeNode = FuncNode + (ast.Lambda,)

DELEGATION_DEPTH = 3
# how many hops a handed function may take through locals, parameters and
# factories before the resolver gives up
RESOLVE_DEPTH = 4


def _dotted(node: ast.AST) -> str:
    """'torch.cuda.graph' for an Attribute/Name chain, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def is_self_attr(node: ast.AST, attr: Optional[str] = None) -> bool:
    """``self.<attr>`` (any attr when None)."""
    return (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self" and (attr is None or node.attr == attr))


def _is_program_ctor(func: ast.AST) -> bool:
    return _dotted(func).rsplit(".", 1)[-1] == "CapturedProgram"


def _is_graph_ctx(expr: ast.AST) -> bool:
    return (isinstance(expr, ast.Call)
            and _dotted(expr.func) in ("torch.cuda.graph", "cuda.graph"))


class Index:
    """One file's lexical tables: the defs each scope binds, each node's
    enclosing scope and class, each class's methods."""

    def __init__(self, tree: ast.AST):
        self.tree = tree
        self.defs: Dict[int, Dict[str, ast.AST]] = {}
        self.parent_scope: Dict[int, Optional[ast.AST]] = {id(tree): None}
        self.enclosing: Dict[int, ast.AST] = {}
        self.cls_of: Dict[int, Optional[ast.ClassDef]] = {}
        self.methods: Dict[int, Dict[str, ast.AST]] = {}

        def visit(node: ast.AST, scope: ast.AST, cls: Optional[ast.ClassDef]) -> None:
            for child in ast.iter_child_nodes(node):
                self.enclosing[id(child)] = scope
                self.cls_of[id(child)] = cls
                if isinstance(child, ast.ClassDef):
                    self.methods[id(child)] = {
                        n.name: n for n in child.body if isinstance(n, FuncNode)}
                    # a class body is no function scope: its methods see the
                    # module's names, and `self` inside them is this class
                    visit(child, scope, child)
                elif isinstance(child, ScopeNode):
                    if isinstance(child, FuncNode) and not isinstance(node, ast.ClassDef):
                        self.defs.setdefault(id(scope), {})[child.name] = child
                    self.parent_scope[id(child)] = scope
                    visit(child, child, cls)
                else:
                    visit(child, scope, cls)

        visit(tree, tree, None)

    def resolve_name(self, name: str, at: ast.AST) -> Optional[ast.AST]:
        scope: Optional[ast.AST] = self.enclosing.get(id(at))
        while scope is not None:
            fn = self.defs.get(id(scope), {}).get(name)
            if fn is not None:
                return fn
            scope = self.parent_scope.get(id(scope))
        return None

    def method(self, at: ast.AST, name: str) -> Optional[ast.AST]:
        cls = self.cls_of.get(id(at))
        if cls is None:
            return None
        return self.methods.get(id(cls), {}).get(name)

    def function_of(self, at: ast.AST) -> Optional[ast.AST]:
        scope = self.enclosing.get(id(at))
        return scope if isinstance(scope, ScopeNode) else None


def own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """The nodes of ``fn``'s body that belong to ``fn`` itself (nested
    defs and lambdas excluded)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, ScopeNode):
            stack.extend(ast.iter_child_nodes(node))


def _param_position(fn: ast.AST, name: str) -> Optional[int]:
    names = [p.arg for p in fn.args.posonlyargs + fn.args.args]
    return names.index(name) if name in names else None


class Resolver:
    """Resolves an expression handed to ``CapturedProgram`` to the defs and
    lambdas it can be."""

    def __init__(self, index: Index):
        self.ix = index

    def resolve(self, expr: ast.AST, at: ast.AST, depth: int = RESOLVE_DEPTH) -> List[ast.AST]:
        if depth < 0:
            return []
        if isinstance(expr, ast.Lambda):
            return [expr]
        if is_self_attr(expr):
            m = self.ix.method(at, expr.attr)
            return [m] if m is not None else []
        if isinstance(expr, ast.Call):
            return self._factory(expr, at, depth - 1)
        if isinstance(expr, ast.Name):
            return self._name(expr.id, at, depth)
        return []

    def _factory(self, call: ast.Call, at: ast.AST, depth: int) -> List[ast.AST]:
        """The defs a factory call returns (``self._decode_body(state)``,
        ``_build_round_block(...)``)."""
        fn = None
        if is_self_attr(call.func):
            fn = self.ix.method(at, call.func.attr)
        elif isinstance(call.func, ast.Name):
            fn = self.ix.resolve_name(call.func.id, at)
        if not isinstance(fn, FuncNode):
            return []
        out: List[ast.AST] = []
        for node in own_nodes(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                out.extend(self.resolve(node.value, node, depth))
        return out

    def _name(self, name: str, at: ast.AST, depth: int) -> List[ast.AST]:
        fn = self.ix.resolve_name(name, at)
        if fn is not None:
            return [fn]
        owner = self.ix.function_of(at)
        if owner is None:
            return []
        out: List[ast.AST] = []
        for node in own_nodes(owner):
            # a local bound to a def, a factory call or a lambda
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name for t in node.targets):
                out.extend(self.resolve(node.value, node, depth - 1))
            # a loop or comprehension target over literal (name, fn) pairs
            gens = []
            if isinstance(node, ast.For):
                gens.append((node.target, node.iter))
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                gens.extend((g.target, g.iter) for g in node.generators)
            for target, it in gens:
                if any(isinstance(n, ast.Name) and n.id == name for n in ast.walk(target)):
                    for ref in ast.walk(it):
                        if isinstance(ref, (ast.Name, ast.Lambda)):
                            out.extend(self.resolve(ref, node, depth - 1))
        if out or isinstance(owner, ast.Lambda):
            return out
        # a parameter: what each caller in this file passes there
        pos = _param_position(owner, name)
        if pos is None and name not in {p.arg for p in owner.args.kwonlyargs}:
            return []
        is_method = (self.ix.cls_of.get(id(owner)) is not None and bool(owner.args.args)
                     and owner.args.args[0].arg == "self")
        argpos = None if pos is None else pos - 1 if is_method else pos
        for call in ast.walk(self.ix.tree):
            if not isinstance(call, ast.Call):
                continue
            if is_method:
                calls_owner = (is_self_attr(call.func, owner.name)
                               and self.ix.method(call, owner.name) is owner)
            else:
                calls_owner = (isinstance(call.func, ast.Name) and call.func.id == owner.name
                               and self.ix.resolve_name(owner.name, call) is owner)
            if not calls_owner:
                continue
            arg = None
            if argpos is not None and argpos < len(call.args) \
                    and not any(isinstance(a, ast.Starred) for a in call.args[:argpos + 1]):
                arg = call.args[argpos]
            for kw in call.keywords:
                if kw.arg == name:
                    arg = kw.value
            if arg is not None:
                out.extend(self.resolve(arg, call, depth - 1))
        return out


def captured_scopes(tree: ast.AST, index: Optional[Index] = None) -> List[dict]:
    """Every captured scope of a file, outermost first: dicts with ``node``
    (a def, a lambda or a ``with`` statement), ``kind`` (``"program"`` for
    a handed function, ``"graph"`` for a ``with torch.cuda.graph`` body,
    ``"delegate"`` for a method reached through ``self.`` calls) and
    ``depth`` (delegation hops from a root)."""
    ix = index or Index(tree)
    res = Resolver(ix)
    found: Dict[int, dict] = {}

    def add(node: ast.AST, kind: str, depth: int) -> None:
        if id(node) not in found:
            found[id(node)] = {"node": node, "kind": kind, "depth": depth}

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_program_ctor(node.func):
            handed = node.args[0] if node.args else next(
                (k.value for k in node.keywords if k.arg == "fn"), None)
            if handed is not None:
                for fn in res.resolve(handed, node):
                    add(fn, "program", 0)
        elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_graph_ctx(item.context_expr) for item in node.items):
            add(node, "graph", 0)
    # follow self.<m>() calls to the same class's methods
    frontier = list(found.values())
    for depth in range(1, DELEGATION_DEPTH + 1):
        nxt = []
        for info in frontier:
            for sub in ast.walk(info["node"]):
                if isinstance(sub, ast.Call) and is_self_attr(sub.func):
                    m = ix.method(sub, sub.func.attr)
                    if m is not None and id(m) not in found:
                        add(m, "delegate", depth)
                        nxt.append(found[id(m)])
        frontier = nxt
    return list(found.values())


def roots(scopes: List[dict]) -> List[dict]:
    """The scopes not lexically inside another one (each subtree is
    walked once, from its outermost captured scope)."""
    inner: Set[int] = set()
    for info in scopes:
        for sub in ast.walk(info["node"]):
            if sub is not info["node"]:
                inner.add(id(sub))
    return [info for info in scopes if id(info["node"]) not in inner]
