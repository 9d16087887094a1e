"""Rule ``async-contract``: zero host blocking between two dispatches of
the pipelined loop.

``ServeEngine(async_loop=True)`` states the decode contract as *no host
wait between consecutive block replays*: round *t* replays block *t*
(``_dispatch_block_async``: the replay, a device copy into the ring, a
non-blocking copy into a pinned host buffer with a CUDA event behind it)
while block *t−1* is still in flight, and the one blocking wait of the
steady state, on block *t−1*'s event, happens after dispatch *t*, inside
the harvest helpers (``_harvest_inflight`` / ``_harvest_rec``, whose
``event.synchronize()`` and ``.numpy()`` are the contract;
``_settle_undispatched``; ``_flush``). The tracer counts the runtime half
(a pipelined block's host ops); this rule is the static half:

* every function with ``async`` in its name under ``inference/`` may not
  call a blocking primitive directly: ``.item()``, ``.tolist()``,
  ``.cpu()``, ``.numpy()``, ``.synchronize()`` / ``torch.cuda.synchronize``,
  ``np.asarray`` / ``np.array`` (host materialization; ``torch.as_tensor``
  uploads without a fetch), ``time.sleep``, or the engine's blocking fetch
  ``._fetch``;
* blocking work belongs to the harvest helpers those functions delegate
  to after the next dispatch is in flight; the delegation is the
  contract, so the rule does not chase calls.

Anything that joins the pipelined path carries ``async`` in its name, and
anything that carries it is fenced off from blocking calls. Zero-waiver:
a blocking call between dispatches serializes the pipeline back into the
synchronous loop.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import Finding, FileCtx, RepoCtx, Rule
from .host_sync import SYNC_ATTRS, SYNC_CALLS
from .tracing import FuncNode, _dotted

RULE_ID = "async-contract"


def _async_roots(tree: ast.AST):
    """Outermost ``*async*``-named defs (a nested async-named helper is
    walked once, from its outermost async-named enclosure)."""
    roots = []
    covered = set()
    for node in ast.walk(tree):
        if not isinstance(node, FuncNode):
            continue
        if "async" not in node.name or id(node) in covered:
            continue
        roots.append(node)
        for sub in ast.walk(node):
            if isinstance(sub, FuncNode):
                covered.add(id(sub))
    return roots


def _check_file(fc: FileCtx) -> Iterator[Finding]:
    for fn in _async_roots(fc.tree):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted in SYNC_CALLS:
                yield Finding(
                    RULE_ID, fc.rel, node.lineno, fc.qualname_at(node),
                    f"{dotted}() on the pipelined dispatch path waits for or "
                    f"fetches from the device between block dispatches (stage "
                    f"the value or move the fetch into the harvest helpers)")
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr in SYNC_ATTRS):
                yield Finding(
                    RULE_ID, fc.rel, node.lineno, fc.qualname_at(node),
                    f".{node.func.attr}() on the pipelined dispatch path "
                    f"blocks the host between block dispatches")
            elif dotted == "time.sleep":
                yield Finding(
                    RULE_ID, fc.rel, node.lineno, fc.qualname_at(node),
                    "time.sleep() on the pipelined dispatch path stalls "
                    "the device for the whole sleep")
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "_fetch"):
                yield Finding(
                    RULE_ID, fc.rel, node.lineno, fc.qualname_at(node),
                    "._fetch() called directly between dispatches — the "
                    "deferred fetch belongs in the harvest helpers, after "
                    "the next block is in flight")


def check(ctx: RepoCtx) -> Iterator[Finding]:
    for fc in ctx.checked_files():
        if "/inference/" in "/" + fc.rel:
            yield from _check_file(fc)


RULE = Rule(
    id=RULE_ID,
    doc="zero host-blocking calls between block dispatches on the pipelined "
        "path (async-named functions under inference/)",
    check=check,
    zero_waiver=True,
)
