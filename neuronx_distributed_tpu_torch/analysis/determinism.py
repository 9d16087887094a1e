"""Rule ``determinism``: scheduling, placement and training decisions
live on the virtual block clock and seeded generators, never on wall
entropy.

The port's replay guarantees (a trace replays the same schedule, chaos
plans replay twice identical, a sampled stream is a function of its seed,
a resumed run draws the batches and masks it would have drawn) assume
that decision code never reads:

* **wall clock**: ``time.time()`` / ``datetime.now()``
  (``time.perf_counter`` stays legal: it feeds measurements, never a
  decision);
* **unseeded module RNG**: ``random.*`` / ``np.random.*`` draws
  (process-global state; ``random.Random(seed)``,
  ``np.random.RandomState(seed)``, ``default_rng(seed)`` are blessed);
* **torch's global generator**: ``torch.rand`` / ``randn`` / ``randint``
  / ``randperm`` / ``bernoulli`` / ``multinomial`` / ``normal`` (and
  their ``*_like`` forms) and the in-place ``uniform_`` / ``normal_`` /
  ``exponential_`` / ``random_`` / ``bernoulli_`` / ``geometric_`` /
  ``cauchy_`` / ``log_normal_`` without ``generator=``; and
  ``torch.manual_seed`` / ``torch.seed`` (reseeding the process-global
  stream from decision code). ``torch.Generator(device).manual_seed(s)``
  is the blessed pattern: every draw of the port passes ``generator=``;
* **bare-set iteration**: ``for x in some_set``; string hashing is salted
  per process, so the order differs between a run and its replay (and
  between the ranks of one group, which then issue collectives in other
  orders). Order-free reductions (``len`` / ``min`` / ``max`` / ``sum`` /
  ``any`` / ``all`` / membership) are fine; ordered consumption goes
  through ``sorted(...)``.

Perimeter (:data:`PERIMETER`): code that reports wall time by design or
only drives the library. Everything else in the package gates. The rule
is linear in the tree: each function's own nodes are visited once, with
the set names of its enclosing functions and class computed once each.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set

from .core import Finding, FileCtx, RepoCtx, Rule
from .tracing import FuncNode, _dotted

# repo-relative path fragments exempt from the wall-clock and RNG checks,
# each with its reason
PERIMETER = (
    "/observability/",          # tracer, incident records: wall time by design
    "/lightning/loggers.py",    # log records carry their wall time
    "/lightning/callbacks.py",  # progress reports time the steps
    "/utils/metrics.py",        # the metrics logger stamps its records
    "/utils/profiler.py",       # the profiler measures wall time
    "/utils/timeline.py",       # the step timeline measures wall time
    "/utils/cp_microbench.py",  # a microbenchmark: times and random inputs
    "/examples/",               # drivers of the library, not decision code
)

WALL_CLOCK = {"time.time", "datetime.now", "datetime.datetime.now",
              "datetime.utcnow", "datetime.datetime.utcnow"}
UNSEEDED_RANDOM_MODS = ("random.", "np.random.", "numpy.random.")
SEEDED_CTORS = {"Random", "RandomState", "default_rng", "Generator",
                "SeedSequence", "Philox", "PCG64", "MT19937", "seed"}
TORCH_GLOBAL_DRAWS = {
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "poisson", "rand_like", "randn_like", "randint_like",
}
TORCH_INPLACE_DRAWS = {"uniform_", "normal_", "exponential_", "random_",
                       "bernoulli_", "geometric_", "cauchy_", "log_normal_"}
TORCH_RESEED = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                "torch.random.seed", "torch.cuda.manual_seed",
                "torch.cuda.manual_seed_all"}
ORDER_FREE = {"len", "min", "max", "sum", "any", "all", "sorted",
              "frozenset", "set"}


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


def _is_set_expr(v: ast.AST) -> bool:
    if isinstance(v, (ast.Set, ast.SetComp)):
        return True
    return isinstance(v, ast.Call) and _dotted(v.func) in ("set", "frozenset")


def _set_annotation(ann: ast.AST) -> bool:
    if isinstance(ann, ast.Subscript):
        ann = ann.value
    return isinstance(ann, ast.Name) and ann.id in ("set", "Set", "frozenset", "FrozenSet")


def _set_bindings(nodes) -> Set[str]:
    """Names (and ``self.x``) the nodes bind to a set: ``set()``, a set
    literal or comprehension, ``frozenset(...)``, or a ``: set``
    annotation."""
    out: Set[str] = set()
    for node in nodes:
        if isinstance(node, ast.Assign) and _is_set_expr(node.value):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and _set_annotation(node.annotation):
            targets = [node.target]
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out.add(t.id)
            elif isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                out.add("self." + t.attr)
    return out


def _expr_key(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return "self." + node.attr
    return ""


def _iter_findings_sets(fc: FileCtx) -> Iterator[Finding]:
    # class-level set attrs (assigned in any method) are visible to every
    # method; a nested def sees its enclosing functions' set locals
    def visit(scope: ast.AST, inherited: Set[str], cls_attrs: Set[str]) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(scope):
            yield from walk(child, inherited, cls_attrs)

    def walk(node: ast.AST, inherited: Set[str], cls_attrs: Set[str]) -> Iterator[Finding]:
        if isinstance(node, ast.ClassDef):
            attrs = {k for k in _set_bindings(fc.walk(node)) if k.startswith("self.")}
            yield from visit(node, set(), attrs)
            return
        if isinstance(node, FuncNode):
            own = list(fc.own(node, stop=FuncNode + (ast.ClassDef,)))
            locals_ = {k for k in _set_bindings(own) if not k.startswith("self.")}
            sets = inherited | locals_ | cls_attrs
            if sets:
                yield from _set_iterations(fc, own, sets)
            for sub in own:
                if isinstance(sub, FuncNode + (ast.ClassDef,)):
                    yield from walk(sub, inherited | locals_, cls_attrs)
            return
        for child in ast.iter_child_nodes(node):
            yield from walk(child, inherited, cls_attrs)

    yield from visit(fc.tree, set(), set())


def _set_iterations(fc: FileCtx, nodes: List[ast.AST], sets: Set[str]) -> Iterator[Finding]:
    for node in nodes:
        iters = []
        if isinstance(node, ast.For):
            iters.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
            iters.extend(g.iter for g in node.generators)
        elif (isinstance(node, ast.Call)
              and _dotted(node.func) in ("list", "tuple", "iter") and node.args):
            iters.append(node.args[0])
        for it in iters:
            key = _expr_key(it)
            if key not in sets:
                continue
            parent = fc.parent(node)
            if isinstance(parent, ast.Call) and _dotted(parent.func) in ORDER_FREE:
                continue
            yield Finding(
                "determinism", fc.rel, it.lineno, fc.qualname_at(node),
                f"bare-set iteration over '{key}' in decision code "
                f"— iteration order is insertion/hash dependent; "
                f"wrap in sorted(...)")


def _call_finding(fc: FileCtx, node: ast.Call) -> Optional[Finding]:
    d = _dotted(node.func)
    leaf = d.rsplit(".", 1)[-1] if d else (
        node.func.attr if isinstance(node.func, ast.Attribute) else "")
    msg = None
    if d in WALL_CLOCK:
        msg = (f"wall-clock read {d}() outside the observability perimeter "
               f"— decisions live on the virtual block clock")
    elif (d and any(d.startswith(m) for m in UNSEEDED_RANDOM_MODS)
          and leaf not in SEEDED_CTORS):
        msg = (f"unseeded module-level rng draw {d}() — use a seeded "
               f"Random/RandomState/default_rng instance")
    elif d in TORCH_RESEED:
        msg = (f"{d}() reseeds torch's process-global generator from "
               f"decision code — draw from a torch.Generator seeded for "
               f"the stream instead")
    elif (d.startswith("torch.") and d.count(".") == 1 and leaf in TORCH_GLOBAL_DRAWS
          and not _has_generator(node)):
        msg = (f"{d}() draws from torch's global generator — pass "
               f"generator= (a seeded torch.Generator)")
    elif (isinstance(node.func, ast.Attribute) and leaf in TORCH_INPLACE_DRAWS
          and not _has_generator(node)):
        msg = (f".{leaf}() draws from torch's global generator — pass "
               f"generator= (a seeded torch.Generator)")
    if msg is None:
        return None
    return Finding("determinism", fc.rel, node.lineno, fc.qualname_at(node), msg)


def check(ctx: RepoCtx) -> Iterator[Finding]:
    for fc in ctx.checked_files():
        if not any(p in "/" + fc.rel for p in PERIMETER):
            for node in fc.nodes:
                if isinstance(node, ast.Call):
                    f = _call_finding(fc, node)
                    if f is not None:
                        yield f
        yield from _iter_findings_sets(fc)


RULE = Rule(
    id="determinism",
    doc="no wall clock, unseeded module RNG, torch global-generator draws or "
        "bare-set iteration in scheduling/placement/training decision code",
    check=check,
)
