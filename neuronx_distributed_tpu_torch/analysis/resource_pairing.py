"""Rule ``resource-pairing``: every page hold, adapter pin and grammar pin
is released on every exit path of the seams that drop a request.

Three sub-checks, JAX's, over the port's serving files
(:data:`TARGET_FILES`) and in the port's idiom:

**Seam release completeness.** A class's pin resources are the ``*_pins``
maps its methods pop (``self._adapter_pins``, ``self._grammar_pins``: the
port releases both in one ``_release_pins``) and, in JAX's idiom, its
``_release_<resource>`` methods. A method that drops a request (pops the
per-request output map ``self._out`` or the submit stamps
``self._submit_ts``, or directly reaches two resources) must reach every
resource's release, directly or through same-class ``self.`` calls up to
three deep, or prove the pin cannot exist with ``assert rid not in
self._<resource>_pins``.

**Page-hold exception safety.** A ``plan()`` / ``begin_chunked()`` hold
still owned by a local while a dispatch-class call runs (``self._dispatch``,
``self._run`` (a captured program), a ``*_programs`` executable,
``lm.insert`` / ``lm.extend``) must sit inside a ``try`` whose handler or
``finally`` rolls it back; a hold still live at an exit is flagged too. A
hold stops being local when it is released or committed, stored on
``self``, or returned.

**Pin recording.** A pool pin taken outside an ``_acquire_*`` accessor
(``self.session.grammars.acquire(g)``, the dynamic
``getattr(self.session, kind + "s").acquire(name)``, a local alias of a
pool) must be recorded in a ``*_pins`` map (or a local alias of one) in
the same function: an unrecorded pin is unreleasable by every seam.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .core import Finding, FileCtx, RepoCtx, Rule
from .tracing import FuncNode, is_self_attr

TARGET_FILES = ("inference/engine.py", "inference/router.py",
                "inference/disagg.py", "inference/causal_lm.py",
                "inference/conversation_tier.py")

RELEASE_METHOD = re.compile(r"^_release_([a-z_]+)$")
PIN_MAP = re.compile(r"^_([a-z_]+)_pins$")
# per-request maps whose pop drops the request from the engine
DROP_MAPS = ("_out", "_submit_ts")
POOLS = ("adapters", "grammars")

PAGE_ACQUIRE = {"plan", "begin_chunked"}
PAGE_RELEASE = {"rollback", "abort_chunked", "commit", "finish_chunked",
                "release"}
RISKY_ATTRS = {"_dispatch", "_run"}
RISKY_LM_ATTRS = {"insert", "extend"}
PROGRAM_FACTORY = re.compile(r"_programs?$")


def _attr_name(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# --------------------------------------------------------------------------
# seam release completeness
# --------------------------------------------------------------------------

def _self_calls(fc: FileCtx, fn: ast.AST) -> Set[str]:
    return {node.func.attr for node in fc.walk(fn)
            if isinstance(node, ast.Call) and is_self_attr(node.func)}


def _direct_releases(fc: FileCtx, fn: ast.AST) -> Set[str]:
    """Resources ``fn`` releases itself: ``self._<r>_pins.pop(...)`` or a
    call of ``self._release_<r>(...)``."""
    out = set()
    for node in fc.walk(fn):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr == "pop" and is_self_attr(node.func.value):
            m = PIN_MAP.match(node.func.value.attr)
            if m:
                out.add(m.group(1))
        elif is_self_attr(node.func):
            m = RELEASE_METHOD.match(node.func.attr)
            if m and m.group(1) != "pins":
                out.add(m.group(1))
    return out


def _asserted_absent(fc: FileCtx, fn: ast.AST) -> Set[str]:
    """Resources whose pin-absence the function asserts:
    ``assert X not in self._<res>_pins`` -> {"<res>"}."""
    out = set()
    for node in fc.walk(fn):
        if not isinstance(node, ast.Assert):
            continue
        for cmp in ast.walk(node.test):
            if (isinstance(cmp, ast.Compare)
                    and any(isinstance(op, ast.NotIn) for op in cmp.ops)):
                for c in cmp.comparators:
                    if isinstance(c, ast.Attribute):
                        m = PIN_MAP.match(c.attr)
                        if m:
                            out.add(m.group(1))
    return out


def _drops_request(fc: FileCtx, fn: ast.AST) -> bool:
    for node in fc.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "pop"
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr in DROP_MAPS):
            return True
    return False


def _check_seams(fc: FileCtx) -> Iterator[Finding]:
    for cls in fc.nodes:
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {n.name: n for n in cls.body if isinstance(n, FuncNode)}
        own = {name: _direct_releases(fc, fn) for name, fn in methods.items()}
        family = set().union(*own.values()) if own else set()
        family |= {m.group(1) for m in map(RELEASE_METHOD.match, methods)
                   if m and m.group(1) != "pins"}
        if not family:
            continue
        calls = {name: _self_calls(fc, fn) for name, fn in methods.items()}

        def reaches(name: str, depth: int = 3) -> Set[str]:
            """Resources released by ``name`` or by the same-class methods
            it calls, up to ``depth`` calls deep."""
            seen_methods = {name}
            got = set(own[name])
            frontier = {name}
            for _ in range(depth):
                nxt = set()
                for m in frontier:
                    for callee in calls.get(m, ()):
                        if callee in methods and callee not in seen_methods:
                            seen_methods.add(callee)
                            got |= own[callee]
                            nxt.add(callee)
                frontier = nxt
            return got

        for name, fn in methods.items():
            if RELEASE_METHOD.match(name) or name.startswith("_acquire"):
                continue
            direct = set(own[name])
            for callee in calls[name]:
                if RELEASE_METHOD.match(callee) and callee in methods:
                    direct |= own[callee]
            if not (_drops_request(fc, fn) or len(direct) >= 2):
                continue
            missing = family - reaches(name) - _asserted_absent(fc, fn)
            if missing:
                yield Finding(
                    "resource-pairing", fc.rel, fn.lineno,
                    f"{cls.name}.{name}",
                    f"seam drops request ownership but never releases the "
                    f"{sorted(missing)} pin(s) (release them, e.g. "
                    f"_release_pins, or assert their absence: `assert rid not "
                    f"in self._<res>_pins`)")


# --------------------------------------------------------------------------
# page-hold exception safety (intraprocedural, JAX's walk)
# --------------------------------------------------------------------------

class _HoldWalker:
    def __init__(self, fc: FileCtx, fn: ast.AST, qual: str):
        self.fc = fc
        self.fn = fn
        self.qual = qual
        self.findings: List[Finding] = []
        self.risky_locals: Set[str] = set()
        # alias -> holder (for-loop element vars over a holder list)
        self.elem_alias: Dict[str, str] = {}

    # -- classification helpers ------------------------------------------
    def _acquire_holder(self, stmt: ast.stmt) -> Optional[Tuple[str, int]]:
        """(holder-name, lineno) when the statement takes a page hold."""
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            if _attr_name(stmt.value.func) in PAGE_ACQUIRE:
                tgt = stmt.targets[0]
                if isinstance(tgt, ast.Name):
                    return tgt.id, stmt.lineno
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            # holder.append(pkv.plan(...)) -> holder owns the hold
            if (_attr_name(call.func) == "append" and call.args
                    and isinstance(call.args[0], ast.Call)
                    and _attr_name(call.args[0].func) in PAGE_ACQUIRE
                    and isinstance(call.func, ast.Attribute)
                    and isinstance(call.func.value, ast.Name)):
                return call.func.value.id, stmt.lineno
        return None

    def _kills(self, node: ast.AST, live: Set[str]) -> Set[str]:
        """Holders this statement releases or transfers ownership of.
        Kills: a release-family call naming the holder (or an element
        alias of it), a store of the holder into ``self`` state
        (attribute / subscript target — ownership transfer), a return of
        the holder. Merely PASSING the holder to a read-only call
        (``table_for(plans[i])``) does not kill."""
        killed: Set[str] = set()
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            if _attr_name(call.func) not in PAGE_RELEASE:
                continue
            arg_names: Set[str] = set()
            for a in list(call.args) + [k.value for k in call.keywords]:
                arg_names |= _names_in(a)
            for h in live:
                aliases = {a for a, owner in self.elem_alias.items()
                           if owner == h}
                if h in arg_names or arg_names & aliases:
                    killed.add(h)
        if isinstance(node, ast.Assign):
            vals = _names_in(node.value)
            for tgt in node.targets:
                if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    killed |= {h for h in live if h in vals}
        if isinstance(node, ast.Return) and node.value is not None:
            killed |= {h for h in live if h in _names_in(node.value)}
        return killed

    def _is_risky(self, node: ast.AST) -> Optional[str]:
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            attr = _attr_name(call.func)
            if attr in RISKY_ATTRS:
                return attr
            if (isinstance(call.func, ast.Attribute)
                    and attr in RISKY_LM_ATTRS
                    and isinstance(call.func.value, (ast.Attribute, ast.Name))
                    and _attr_name(call.func.value) in ("lm", "self")):
                return attr
            if (isinstance(call.func, ast.Name)
                    and call.func.id in self.risky_locals):
                return call.func.id
        return None

    def _note_risky_locals(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            attr = _attr_name(stmt.value.func)
            if attr and PROGRAM_FACTORY.search(attr):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        self.risky_locals.add(tgt.id)
                    elif isinstance(tgt, ast.Tuple):
                        for e in tgt.elts:
                            if isinstance(e, ast.Name):
                                self.risky_locals.add(e.id)

    def _protect_names(self, trystmt: ast.Try) -> Set[str]:
        """Names a try's except/finally bodies roll back — independent of
        what is currently live, so holds acquired INSIDE the try body are
        protected too. Includes the iterables of ``for p in holder:
        rollback(p)`` handler loops."""
        out: Set[str] = set()
        for body in [h.body for h in trystmt.handlers] + [trystmt.finalbody]:
            for stmt in body:
                for call in ast.walk(stmt):
                    if (isinstance(call, ast.Call)
                            and _attr_name(call.func) in PAGE_RELEASE):
                        for a in call.args:
                            out |= _names_in(a)
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.For) and any(
                            isinstance(c, ast.Call)
                            and _attr_name(c.func) in PAGE_RELEASE
                            for c in ast.walk(sub)):
                        out |= _names_in(sub.iter)
        return out

    # -- the walk ---------------------------------------------------------
    def run(self) -> List[Finding]:
        live_end = self._body(list(self.fn.body), set(), set())
        for h, line in sorted(live_end):
            self.findings.append(Finding(
                "resource-pairing", self.fc.rel, line, self.qual,
                f"page hold '{h}' (line {line}) can leave the function "
                f"without commit/rollback on the fall-through path"))
        return self.findings

    def _body(self, stmts: List[ast.stmt], live: Set[Tuple[str, int]],
              protected: Set[str]) -> Set[Tuple[str, int]]:
        live = set(live)
        for stmt in stmts:
            self._note_risky_locals(stmt)
            acq = self._acquire_holder(stmt)
            live_names = {h for h, _ in live}
            if isinstance(stmt, ast.For):
                # record element aliases before walking the body
                if isinstance(stmt.target, ast.Name):
                    for h in live_names & _names_in(stmt.iter):
                        self.elem_alias[stmt.target.id] = h
                live = self._body(list(stmt.body), live, protected)
            elif isinstance(stmt, ast.While):
                live = self._body(list(stmt.body), live, protected)
            elif isinstance(stmt, ast.If):
                l1 = self._body(list(stmt.body), live, protected)
                l2 = self._body(list(stmt.orelse), live, protected)
                # a kill in EITHER branch counts (acquire and kill are
                # routinely behind the same `if self.paged:` guard — a
                # strict union would flag every guarded release); new
                # acquisitions from either branch stay live
                killed = (live - l1) | (live - l2)
                live = (live - killed) | (l1 - live) | (l2 - live)
            elif isinstance(stmt, ast.Try):
                prot = protected | self._protect_names(stmt)
                live = self._body(list(stmt.body), live, prot)
                for handler in stmt.handlers:
                    live = self._body(list(handler.body), live, protected)
                live = self._body(list(stmt.finalbody), live, protected)
            elif isinstance(stmt, (ast.With,)):
                live = self._body(list(stmt.body), live, protected)
            else:
                risky = self._is_risky(stmt)
                if risky is not None:
                    for h, line in sorted(live):
                        if h in protected:
                            continue
                        self.findings.append(Finding(
                            "resource-pairing", self.fc.rel, stmt.lineno,
                            self.qual,
                            f"dispatch-class call '{risky}' runs while page "
                            f"hold '{h}' (line {line}) is live and "
                            f"unprotected — a failed dispatch leaks the "
                            f"hold (PR 5 storm class); wrap in try/except "
                            f"with rollback"))
                killed = self._kills(stmt, {h for h, _ in live})
                live = {(h, ln) for h, ln in live if h not in killed}
                if isinstance(stmt, (ast.Return, ast.Raise)):
                    # an explicit raise after kills: remaining holds leak
                    for h, line in sorted(live):
                        if h in protected:
                            continue
                        self.findings.append(Finding(
                            "resource-pairing", self.fc.rel, stmt.lineno,
                            self.qual,
                            f"exit at line {stmt.lineno} with page hold "
                            f"'{h}' (line {line}) still unreleased"))
                    live = set()
            if acq is not None:
                # the Try branch above already walked the acquire's body;
                # register liveness AFTER the statement executes
                if not isinstance(stmt, ast.Try):
                    live.add(acq)
        return live


def _check_holds(fc: FileCtx) -> Iterator[Finding]:
    for node in fc.nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            has_acquire = any(
                isinstance(c, ast.Call)
                and _attr_name(c.func) in PAGE_ACQUIRE
                for c in fc.walk(node))
            if not has_acquire:
                continue
            qual = fc.qualname_at(node) + "." + node.name \
                if fc.qualname_at(node) != "<module>" else node.name
            yield from _HoldWalker(fc, node, qual).run()


# --------------------------------------------------------------------------
# pin recording
# --------------------------------------------------------------------------

def _aliases(fc: FileCtx, fn: ast.AST) -> Tuple[Set[str], Set[str]]:
    """(pool aliases, pin-map aliases): locals bound to an expression that
    names a pool (``pool = self.session.adapters if ... else ...``) or a
    ``*_pins`` map (``pins = self._adapter_pins if ...``; ``for kind, pins
    in (("adapter", self._adapter_pins), ...)``)."""
    pools: Set[str] = set()
    pin_maps: Set[str] = set()
    for node in fc.walk(fn):
        pairs = []
        if isinstance(node, ast.Assign):
            pairs = [(t, node.value) for t in node.targets]
        elif isinstance(node, ast.For):
            pairs = [(node.target, node.iter)]
        for tgt, value in pairs:
            attrs = {a.attr for a in ast.walk(value) if isinstance(a, ast.Attribute)}
            names = {n.id for n in ast.walk(tgt) if isinstance(n, ast.Name)}
            if attrs & set(POOLS):
                pools |= names
            if any(PIN_MAP.match(a) for a in attrs):
                pin_maps |= names
    return pools, pin_maps


def _is_pool_acquire(call: ast.AST, pools: Set[str]) -> bool:
    if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
            and call.func.attr == "acquire"):
        return False
    recv = call.func.value
    if isinstance(recv, ast.Attribute):
        return recv.attr in POOLS
    if isinstance(recv, ast.Name):
        return recv.id in pools
    # getattr(self.session, kind + "s"): a pool named at run time
    return isinstance(recv, ast.Call) and _attr_name(recv.func) == "getattr"


def _check_pin_recording(fc: FileCtx) -> Iterator[Finding]:
    for node in fc.nodes:
        if not isinstance(node, FuncNode) or node.name.startswith("_acquire_"):
            continue
        acquires = [sub for sub in fc.walk(node) if _is_pool_acquire(sub, set())
                    or (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "acquire")]
        if not acquires:
            continue
        pools, pin_maps = _aliases(fc, node)
        acquires = [sub for sub in acquires if _is_pool_acquire(sub, pools)]
        if not acquires:
            continue
        records = any(
            isinstance(sub, ast.Assign) and any(
                isinstance(t, ast.Subscript) and (
                    (isinstance(t.value, ast.Attribute) and t.value.attr.endswith("_pins"))
                    or (isinstance(t.value, ast.Name) and t.value.id in pin_maps))
                for t in sub.targets)
            for sub in fc.walk(node))
        if not records:
            for a in acquires:
                yield Finding(
                    "resource-pairing", fc.rel, a.lineno,
                    fc.qualname_at(a),
                    "pool pin acquired outside _acquire_* without recording "
                    "it in a *_pins map: no seam can ever release it")


def check(ctx: RepoCtx) -> Iterator[Finding]:
    for fc in ctx.checked_files():
        if not any(fc.rel.endswith(t) for t in TARGET_FILES):
            continue
        yield from _check_seams(fc)
        yield from _check_holds(fc)
        yield from _check_pin_recording(fc)


RULE = Rule(
    id="resource-pairing",
    doc="page holds / adapter pins / grammar pins released (or provably "
        "absent) on every seam exit path, exception paths included",
    check=check,
    zero_waiver=True,
)
