"""Rule ``surface-drift``: the string registries that tie the fault plan,
the tests' observability names and the bench headline surfaces together
stay reconciled.

A ``FaultPlan`` probability is chaos coverage only if an injector reads it
and a test drives it; a stats key or event name a test asserts on is a
guarantee only while a producer still emits it (the registry-backed stats
view defaults to 0, so a producer rename fails silently). Sub-checks:

* ``faultplan``: every ``*_prob`` field of the port's ``FaultPlan``
  (``inference/faults.py``) is read as an attribute by an injector (the
  port's ``FaultInjector`` in ``faults.py``, or any other module; the
  dataclass field itself never counts) and named in some
  ``tests/test_torch_*.py``.
* ``observability-names``: every ``X.stats["..."]`` key and
  ``.events("...")`` name a port test reads has a producer in the port (a
  ``stats`` store or dict literal, the ``STAT_KEYS`` / ``_STAT_KEYS``
  registry literal, a tracer ``instant`` / ``span`` / ``counter`` /
  ``complete`` name, exact or by f-string prefix), or the test produces
  it itself.
* ``headline-rule`` / ``headline-producer`` / ``headline-artifact``
  (:func:`check_headline`): a bench module's ``HEADLINE_KEYS`` against a
  regress module's ``RULES``, the bench's own producing stores, and the
  newest artifact matching a glob. They run only when the caller names
  the three (``run_checks(..., headline={"bench": ..., "regress": ...,
  "artifacts": ...})``): the port has no bench of its own yet, so its
  default run and the CLI skip them and read no ``BENCHMARK.json`` or
  ``BENCH_*.json``.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path
from typing import Iterator, List, Optional, Set, Tuple

from .core import Finding, FileCtx, RepoCtx, Rule

NONNUMERIC_KEY = re.compile(r"(_error|_basis)$|^(metric|train_measured)$")
SERVING_KEY = re.compile(
    r"^(serve_|router_|soak_|paged_|adapter_|grammar_|tier_)")
TRACER_METHODS = {"instant", "span", "counter", "complete"}


def _literal_assign(nodes, name: str) -> Optional[object]:
    for node in nodes:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name:
                try:
                    return ast.literal_eval(
                        node.value if isinstance(node, ast.Assign)
                        else node.value)
                except ValueError:
                    return None
    return None


def _newest_artifact(root: Path, pattern: str) -> Optional[Tuple[Path, dict]]:
    best: Optional[Tuple[int, Path, dict]] = None
    for p in sorted(root.glob(pattern)):
        try:
            doc = json.loads(p.read_text())
        except (OSError, json.JSONDecodeError):
            continue
        parsed = doc.get("parsed")
        if not isinstance(parsed, dict) or "headline_keys" not in parsed:
            continue
        n = doc.get("n", 0)
        if best is None or n > best[0]:
            best = (n, p, parsed)
    if best is None:
        return None
    return best[1], best[2]


def check_headline(ctx: RepoCtx, bench_rel: str, regress_rel: str,
                   artifacts: str) -> Iterator[Finding]:
    """The three ``headline-*`` sub-checks over the bench module
    ``bench_rel``, the regress-rule module ``regress_rel`` (repo-relative)
    and the newest artifact matching ``artifacts`` under the root."""
    bench = ctx.maybe_file(bench_rel)
    regress = ctx.maybe_file(regress_rel)
    if bench is None or regress is None:
        return
    headline = _literal_assign(bench.nodes, "HEADLINE_KEYS")
    rules = _literal_assign(regress.nodes, "RULES")
    if headline is None:
        yield Finding("surface-drift", bench.rel, 1, "<module>",
                      "HEADLINE_KEYS is not a literal tuple/list "
                      "(bench_regress ast-parses it — keep it literal)")
        return
    if rules is None:
        yield Finding("surface-drift", regress.rel, 1, "<module>",
                      "RULES is not a literal list (direction table must "
                      "stay statically auditable)")
        return
    pats = [str(r[0]) for r in rules]
    for key in headline:
        key = str(key)
        if NONNUMERIC_KEY.search(key):
            continue
        if not any(re.fullmatch(p, key) for p in pats):
            yield Finding(
                "surface-drift", bench.rel, 1, "HEADLINE_KEYS",
                f"headline key '{key}' matches no bench_regress RULES "
                f"pattern — it reports as 'info' and never gates")
    # headline-producer: a serving headline key must have a producing
    # store in bench.py. HEADLINE_KEYS itself is a tuple of constants —
    # never a Subscript store — so the declaration can't self-satisfy.
    produced: Set[str] = set()
    produced_prefixes: List[str] = []
    for node in bench.nodes:
        if (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Store)):
            if (isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)):
                produced.add(node.slice.value)
            elif (isinstance(node.slice, ast.JoinedStr)
                    and node.slice.values):
                head = node.slice.values[0]
                if (isinstance(head, ast.Constant)
                        and isinstance(head.value, str) and head.value):
                    produced_prefixes.append(head.value)
    for key in headline:
        key = str(key)
        if NONNUMERIC_KEY.search(key) or not SERVING_KEY.match(key):
            continue
        if key in produced:
            continue
        if any(key.startswith(p) for p in produced_prefixes):
            continue
        yield Finding(
            "surface-drift", bench.rel, 1, "HEADLINE_KEYS",
            f"serving headline key '{key}' has no producing store in "
            f"bench.py (no literal out['{key}'] = ... outside the "
            f"HEADLINE_KEYS declaration) — it gates forever on the "
            f"baseline's fossilized value")
    art = _newest_artifact(ctx.root, artifacts)
    if art is None:
        return
    apath, parsed = art
    rel = apath.name
    embedded = {str(k) for k in parsed.get("headline_keys", [])}
    current = {str(k) for k in headline}
    for k in sorted(embedded - current):
        yield Finding(
            "surface-drift", rel, 0, "headline_keys",
            f"committed artifact {rel} gates on '{k}' which bench.py no "
            f"longer declares (retired key lingering in the baseline)")
    for k in sorted(current - embedded):
        yield Finding(
            "surface-drift", rel, 0, "headline_keys",
            f"headline key '{k}' missing from {rel}'s embedded "
            f"headline_keys — regenerate the baseline")
    for k in sorted(current):
        if NONNUMERIC_KEY.search(k) or not SERVING_KEY.match(k):
            continue
        if k not in parsed:
            yield Finding(
                "surface-drift", rel, 0, "parsed",
                f"serving headline key '{k}' absent from the newest "
                f"committed baseline {rel} — it compares as new_key "
                f"forever and is effectively ungated (refresh via "
                f"scripts/bench_cpu_basis.py)")


def _check_faultplan(ctx: RepoCtx) -> Iterator[Finding]:
    fp = ctx.package_file("inference/faults.py")
    if fp is None:
        return
    fields: List[Tuple[str, int]] = []
    for node in fp.nodes:
        if isinstance(node, ast.ClassDef) and node.name == "FaultPlan":
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.target, ast.Name)
                        and stmt.target.id.endswith("_prob")):
                    fields.append((stmt.target.id, stmt.lineno))
    # an injector READS the field: an ast.Attribute access anywhere in the
    # package (the dataclass definition is an AnnAssign target, never an
    # Attribute, so it cannot satisfy itself)
    read_attrs: Set[str] = set()
    for fc in ctx.checked_files():
        read_attrs |= {node.attr for node in fc.nodes if isinstance(node, ast.Attribute)}
    test_src = "\n".join(tc.source for tc in ctx.test_files())
    for name, line in fields:
        if name not in read_attrs:
            yield Finding(
                "surface-drift", fp.rel, line, "FaultPlan",
                f"FaultPlan.{name} has no injector call site in the "
                f"package — a chaos knob nothing reads is dead coverage")
        if name not in test_src:
            yield Finding(
                "surface-drift", fp.rel, line, "FaultPlan",
                f"FaultPlan.{name} is never mentioned in tests — the "
                f"seam has no chaos coverage")


def _tracer_wrappers(fc: FileCtx) -> Set[str]:
    """Functions that hand their first parameter to a tracer method as the
    event name (the engine's ``_trace_req(name, rid, ...)``): their calls
    produce events as the tracer's own do."""
    out: Set[str] = set()
    for fn in fc.nodes:
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = [a.arg for a in fn.args.posonlyargs + fn.args.args if a.arg != "self"]
        if not params:
            continue
        for node in fc.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in TRACER_METHODS and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id == params[0]):
                out.add(fn.name)
                break
    return out


def _names_from_file(fc: FileCtx, wrappers: Set[str] = frozenset()
                     ) -> Tuple[Set[str], Set[str], List[str]]:
    """(stats keys, event names, event f-string prefixes) produced by one
    file. Producers of a stats key: a ``stats`` subscript (``self.stats``
    or a bare ``stats`` dict), a dict literal assigned/returned as
    ``stats`` (the speculative/medusa result-stats idiom), or the
    ``STAT_KEYS`` / ``_STAT_KEYS`` registry literal. Producers of an event:
    a tracer method's or a tracer wrapper's (``wrappers``) first
    argument."""
    stats: Set[str] = set()
    events: Set[str] = set()
    prefixes: List[str] = []
    for registry in ("_STAT_KEYS", "STAT_KEYS"):
        keys = _literal_assign(fc.nodes, registry)
        if isinstance(keys, (list, tuple)):
            stats |= {str(k) for k in keys}
    emitters = TRACER_METHODS | set(wrappers)
    for node in fc.nodes:
        if (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, (ast.Store, ast.Del))
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            # WRITES only: a read is a consumer, not evidence the key
            # exists (else the consumer check would satisfy itself)
            recv = node.value
            if ((isinstance(recv, ast.Attribute) and recv.attr == "stats")
                    or (isinstance(recv, ast.Name) and recv.id == "stats")):
                stats.add(node.slice.value)
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            tgt_names = {t.id for t in node.targets
                         if isinstance(t, ast.Name)}
            tgt_names |= {t.attr for t in node.targets
                          if isinstance(t, ast.Attribute)}
            if "stats" in tgt_names:
                for k in node.value.keys:
                    if isinstance(k, ast.Constant) and isinstance(
                            k.value, str):
                        stats.add(k.value)
        if (isinstance(node, ast.Call)
                and isinstance(node.func, (ast.Attribute, ast.Name))
                and (node.func.attr if isinstance(node.func, ast.Attribute)
                     else node.func.id) in emitters
                and node.args):
            a0 = node.args[0]
            if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                events.add(a0.value)
            elif isinstance(a0, ast.JoinedStr) and a0.values:
                head = a0.values[0]
                if (isinstance(head, ast.Constant)
                        and isinstance(head.value, str)
                        and head.value):
                    prefixes.append(head.value)
    return stats, events, prefixes


def _check_observability_names(ctx: RepoCtx) -> Iterator[Finding]:
    wrappers: Set[str] = set()
    for fc in ctx.checked_files():
        wrappers |= _tracer_wrappers(fc)
    stats: Set[str] = set()
    events: Set[str] = set()
    prefixes: List[str] = []
    for fc in ctx.checked_files():
        s, e, p = _names_from_file(fc, wrappers)
        stats |= s
        events |= e
        prefixes.extend(p)
    if not stats and not events:
        return
    for tc in ctx.test_files():
        if "stats[" not in tc.source and ".events(" not in tc.source:
            continue    # no consumer to hold
        # a test that writes its own stats key / emits its own event is
        # its own producer (the ad-hoc-key and custom-event unit tests)
        own_stats, own_events, own_prefixes = _names_from_file(tc)
        for node in tc.nodes:
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Attribute)
                    and node.value.attr == "stats"
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)):
                key = node.slice.value
                if key not in stats and key not in own_stats:
                    yield Finding(
                        "surface-drift", tc.rel, node.lineno,
                        tc.qualname_at(node),
                        f"test reads stats[{key!r}] but no package code "
                        f"produces that key — the registry view defaults "
                        f"to 0, so this assert passes on a dead counter")
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "events"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                name = node.args[0].value
                if name in events or name in own_events:
                    continue
                if any(name.startswith(p)
                       for p in prefixes + own_prefixes):
                    continue
                yield Finding(
                    "surface-drift", tc.rel, node.lineno,
                    tc.qualname_at(node),
                    f"test filters tracer events({name!r}) but no package "
                    f"code emits that event name")


def check(ctx: RepoCtx) -> Iterator[Finding]:
    if ctx.headline is not None:
        yield from check_headline(ctx, ctx.headline["bench"], ctx.headline["regress"],
                                  ctx.headline["artifacts"])
    yield from _check_faultplan(ctx)
    yield from _check_observability_names(ctx)


RULE = Rule(
    id="surface-drift",
    doc="FaultPlan fields / the tests' observability names stay reconciled "
        "with their producers; the HEADLINE_KEYS / regress rules / artifact "
        "sub-checks run when a bench is named (the port has none yet)",
    check=check,
)
