"""Rule ``cache-replication``: a captured program's outputs leave it
through the capture boundary copy, never as the graph's own buffers.

JAX pins each program's cache at its boundary (``_replicate_out``) so the
next program gets the layout it was compiled for. The port's analogue is
the graph's static outputs: ``CapturedProgram.replay()`` returns the
tensors the captured graph writes (``static_out``), and the next replay of
any program sharing the graph pool may overwrite them. ``__call__`` copies
them through ``_clone_out`` before they leave. The rule keeps that
boundary: in any function, a value taken from a ``.replay()`` call or a
``.static_out`` read (and any name bound from one) that the function
returns or stores on ``self`` must pass through ``_clone_out(...)``. A
function that replays and then returns an attribute of its own object
hands back a buffer the graph writes, and only the blessed buffers below
may be handed back.

Blessed, as JAX names its pins:

* ``CapturedProgram.replay`` itself, the primitive that defines the raw
  return (its callers are held instead);
* ``FusedDecode.out``, the fused decode block's (steps + 1, b) emissions
  and flags: the engine fetches it once a block, before the next replay.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from .core import Finding, FileCtx, RepoCtx, Rule
from .tracing import FuncNode, is_self_attr

BOUNDARY_COPIES = ("_clone_out", "clone_out")
BLESSED_FUNCTIONS = {"CapturedProgram.replay"}
BLESSED_BUFFERS = {("FusedDecode", "out")}


def _is_raw(node: ast.AST) -> bool:
    """A ``.replay()`` call or a ``.static_out`` read."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "replay"):
        return True
    return isinstance(node, ast.Attribute) and node.attr == "static_out"


def _is_copy(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else f.id if isinstance(f, ast.Name) else ""
    return name in BOUNDARY_COPIES


def _uncovered(expr: ast.AST, raw_names: Set[str]) -> bool:
    """True when ``expr`` carries a raw graph output outside any boundary
    copy. Walked top-down: a copy clears everything below it."""
    if _is_copy(expr):
        return False
    if _is_raw(expr):
        return True
    if isinstance(expr, ast.Name) and expr.id in raw_names:
        return True
    return any(_uncovered(c, raw_names) for c in ast.iter_child_nodes(expr))


def _raw_names(fc: FileCtx, fn: ast.AST) -> Set[str]:
    names: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in fc.own(fn):
            if isinstance(node, ast.Assign) and _uncovered(node.value, names):
                for t in node.targets:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Name) and leaf.id not in names:
                            names.add(leaf.id)
                            changed = True
    return names


def _check_function(fc: FileCtx, fn: ast.AST) -> Iterator[Finding]:
    qual = fc.qualname_of(fn)
    if qual in BLESSED_FUNCTIONS:
        return
    raw = _raw_names(fc, fn)
    replays = any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                  and n.func.attr == "replay" for n in fc.own(fn))
    cls = qual.rsplit(".", 1)[0] if "." in qual else ""
    for node in fc.own(fn):
        if isinstance(node, ast.Return) and node.value is not None:
            if _uncovered(node.value, raw):
                yield Finding(
                    "cache-replication", fc.rel, node.lineno, qual,
                    "returns a graph's static output without _clone_out: the "
                    "next replay into the shared pool overwrites it")
            elif replays:
                v = node.value
                for elem in (v.elts if isinstance(v, (ast.Tuple, ast.List)) else [v]):
                    sub = elem.value if isinstance(elem, ast.Subscript) else elem
                    if is_self_attr(sub) and (cls, sub.attr) not in BLESSED_BUFFERS:
                        yield Finding(
                            "cache-replication", fc.rel, node.lineno, qual,
                            f"replays a graph and returns self.{sub.attr}, a buffer "
                            f"the graph may write, without _clone_out (only "
                            f"{sorted('.'.join(b) for b in BLESSED_BUFFERS)} are "
                            f"blessed)")
        elif isinstance(node, ast.Assign) and _uncovered(node.value, raw):
            for t in node.targets:
                stored = [s for s in ast.walk(t) if isinstance(s, (ast.Attribute, ast.Subscript))
                          and isinstance(s.ctx, ast.Store)]
                if any(isinstance(_root(s), ast.Name) and _root(s).id == "self" for s in stored):
                    yield Finding(
                        "cache-replication", fc.rel, node.lineno, qual,
                        "stores a graph's static output on self without "
                        "_clone_out: the next replay into the shared pool "
                        "overwrites it")


def _root(node: ast.AST) -> ast.AST:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node


def _check_file(fc: FileCtx) -> Iterator[Finding]:
    if "replay" not in fc.source and "static_out" not in fc.source:
        return
    # only a function that holds a raw output can hand one back
    fns = []
    for node in fc.nodes:
        if _is_raw(node):
            owner = fc.parent(node)
            while owner is not None and not isinstance(owner, FuncNode + (ast.Lambda,)):
                owner = fc.parent(owner)
            if isinstance(owner, FuncNode) and owner not in fns:
                fns.append(owner)
    for fn in fns:
        yield from _check_function(fc, fn)


def check(ctx: RepoCtx) -> Iterator[Finding]:
    for fc in ctx.checked_files():
        yield from _check_file(fc)


RULE = Rule(
    id="cache-replication",
    doc="a captured graph's static outputs (.replay() results, .static_out) "
        "leave a function only through _clone_out; FusedDecode.out is the one "
        "blessed buffer",
    check=check,
    zero_waiver=True,
)
