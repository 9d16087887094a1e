"""nxdcheck rule engine for the port: stdlib-only (``ast`` + ``tokenize``)
static enforcement of the serving stack's load-bearing contracts, over the
port's own code in the port's own idiom.

The contracts are the ones the port claims in ``README.md`` and ``PERF.md``:

* no host reads inside captured programs (at most 2 host ops per fused
  block: one replay, one fetch);
* the graph's static outputs never leave a program uncopied (a later
  replay into the shared pool overwrites them);
* every page hold, adapter pin and grammar pin is released at every seam
  that drops a request;
* decisions read the virtual block clock and seeded generators only;
* the fault plan, the tests' observability names and (when the caller
  names them) the bench headline surfaces stay reconciled;
* nothing blocks the host between two dispatches of the pipelined loop.

Each rule is a callable over a :class:`RepoCtx` yielding
:class:`Finding`\\ s; waivers are explicit and carry justifications; the
CLI (``scripts/nxdcheck_torch.py``) exits nonzero on any unwaived finding.
Nothing in this package imports ``torch``, ``jax`` or the JAX package.

Waiver syntax
-------------

In-file (preferred: the justification lives next to the code)::

    something_flagged()  # nxdcheck: waive <rule-id> -- <justification>

or on the line directly above the finding. Repo-level, for findings whose
justification spans files: ``neuronx_distributed_tpu_torch/analysis/
waivers.txt`` lines of the form

    <rule-id> <relpath-glob> <qualname-glob> -- <justification>

Blank lines and ``#`` comments are ignored. A waiver with an empty
justification, or naming an unknown rule, is itself a finding (``waiver``
pseudo-rule), and a waived finding of a zero-waiver rule comes back as a
gating ``waiver`` finding.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import io
import re
import tokenize
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

__all__ = [
    "Finding", "Rule", "FileCtx", "RepoCtx", "run_checks", "load_waivers",
    "parse_inline_waivers", "PORT_PACKAGE",
]

PORT_PACKAGE = "neuronx_distributed_tpu_torch"

# comment grammar:  # nxdcheck: waive <rule-id>[,<rule-id>...] -- reason
_WAIVE_RE = re.compile(
    r"#\s*nxdcheck:\s*waive\s+([a-z0-9_,\-]+)\s*(?:--\s*(.*))?$")


@dataclasses.dataclass
class Finding:
    """One contract violation at a source location. ``waived`` findings
    still appear in the JSON report but do not gate."""

    rule: str
    path: str                    # repo-relative, forward slashes
    line: int
    qualname: str                # enclosing function/class path, or "<module>"
    message: str
    waived: bool = False
    waiver_reason: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    """A named contract. ``check`` walks the repo context and yields raw
    findings; the engine applies waivers afterwards."""

    id: str
    doc: str
    check: Callable[["RepoCtx"], Iterator[Finding]]
    zero_waiver: bool = False    # a waiver on this rule is itself a failure


class FileCtx:
    """One parsed source file: AST, per-line waiver comments, and on first
    use one indexing pass (:meth:`_index`) that gives every node its parent
    link, its enclosing-scope qualname and its subtree as a slice of one
    pre-order list, so rules iterate lists instead of re-walking trees."""

    def __init__(self, root: Path, path: Path):
        self.rel = path.relative_to(root).as_posix()
        self.source = path.read_text()
        self.tree = ast.parse(self.source, filename=self.rel)
        # line -> (rule-ids or {"*"}, reason); an empty reason is reported
        self.waivers: Dict[int, Tuple[set, str]] = (
            parse_inline_waivers(self.source) if "nxdcheck" in self.source else {})
        self._order: Optional[List[ast.AST]] = None

    def _index(self) -> List[ast.AST]:
        if self._order is None:
            order: List[ast.AST] = []
            parent_at: List[int] = []
            quals: Dict[int, str] = {}
            stack: List[Tuple[ast.AST, int, Tuple[str, ...]]] = [(self.tree, -1, ())]
            while stack:
                node, p, names = stack.pop()
                i = len(order)
                order.append(node)
                parent_at.append(p)
                if p >= 0:
                    node._nxd_parent = order[p]  # type: ignore[attr-defined]
                quals[id(node)] = ".".join(names) if names else "<module>"
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    names = names + (node.name,)
                elif isinstance(node, ast.Lambda):
                    names = names + ("<lambda>",)
                children = list(ast.iter_child_nodes(node))
                for child in reversed(children):
                    stack.append((child, i, names))
            size = [1] * len(order)
            for i in range(len(order) - 1, 0, -1):
                size[parent_at[i]] += size[i]
            self._pos = {id(n): i for i, n in enumerate(order)}
            self._size = size
            self._quals = quals
            self._order = order
        return self._order

    @property
    def nodes(self) -> List[ast.AST]:
        """Every node of the file, in pre-order."""
        return self._index()

    def walk(self, node: ast.AST) -> List[ast.AST]:
        """The nodes of ``node``'s subtree (``node`` first), in pre-order."""
        order = self._index()
        i = self._pos[id(node)]
        return order[i: i + self._size[i]]

    def own(self, scope: ast.AST, stop=(ast.FunctionDef, ast.AsyncFunctionDef,
                                        ast.ClassDef, ast.Lambda)) -> Iterator[ast.AST]:
        """The nodes of ``scope``'s subtree (``scope`` itself excluded) that
        belong to it: a nested node of a ``stop`` type is yielded, its
        subtree is not."""
        order = self._index()
        i = self._pos[id(scope)] + 1
        end = self._pos[id(scope)] + self._size[self._pos[id(scope)]]
        while i < end:
            node = order[i]
            yield node
            i += self._size[i] if isinstance(node, stop) else 1

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        self._index()
        return getattr(node, "_nxd_parent", None)

    def qualname_at(self, node: ast.AST) -> str:
        self._index()
        return self._quals.get(id(node), "<module>")

    def qualname_of(self, fn: ast.AST) -> str:
        """The dotted name of a def itself ("Class.method")."""
        outer = self.qualname_at(fn)
        name = getattr(fn, "name", "<lambda>")
        return name if outer == "<module>" else f"{outer}.{name}"


def parse_inline_waivers(source: str) -> Dict[int, Tuple[set, str]]:
    out: Dict[int, Tuple[set, str]] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _WAIVE_RE.search(tok.string)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                out[tok.start[0]] = (rules, (m.group(2) or "").strip())
    except tokenize.TokenError:
        pass
    return out


class RepoCtx:
    """Lazy repo view the rules share: the parsed package files plus ast
    access to repo-level surfaces. Built once per run; parsing is the
    dominant cost.

    ``package`` is the package directory under ``root`` the rules read
    (the port by default; ``"neuronx_distributed_tpu"`` runs the rules that
    share JAX's idioms over JAX-shaped trees). ``headline`` names the bench
    surfaces surface-drift's ``headline-*`` sub-checks read: a dict with
    ``bench`` and ``regress`` (repo-relative module paths) and
    ``artifacts`` (a glob under ``root``); None skips those sub-checks."""

    def __init__(self, root: Path, package: str = PORT_PACKAGE,
                 headline: Optional[Dict[str, str]] = None):
        self.root = Path(root)
        self.package = package
        self.headline = headline
        self._files: Optional[List[FileCtx]] = None
        self._cache: Dict[str, FileCtx] = {}

    @property
    def files(self) -> List[FileCtx]:
        if self._files is None:
            pkg = self.root / self.package
            self._files = [self.file(p) for p in sorted(pkg.rglob("*.py"))
                           if "__pycache__" not in p.parts]
        return self._files

    def file(self, path: Path) -> FileCtx:
        key = str(path)
        if key not in self._cache:
            self._cache[key] = FileCtx(self.root, path)
        return self._cache[key]

    def maybe_file(self, rel: str) -> Optional[FileCtx]:
        p = self.root / rel
        if not p.exists():
            return None
        return self.file(p)

    def package_file(self, sub: str) -> Optional[FileCtx]:
        """The package's module at ``sub`` ("inference/faults.py")."""
        return self.maybe_file(f"{self.package}/{sub}")

    def test_files(self) -> List[FileCtx]:
        """The top-level test files of the package: ``tests/test_torch_*.py``
        for the port, ``tests/test_*.py`` for any other package."""
        tdir = self.root / "tests"
        if not tdir.is_dir():
            return []
        pattern = "test_torch_*.py" if self.package == PORT_PACKAGE else "test_*.py"
        return [self.file(p) for p in sorted(tdir.glob(pattern))]

    def checked_files(self) -> Iterator[FileCtx]:
        """The package files the code rules read (the checker itself is
        not checked)."""
        for fc in self.files:
            if "/analysis/" not in fc.rel:
                yield fc


def load_waivers(path: Path) -> List[Tuple[str, str, str, str]]:
    """waivers.txt -> [(rule, relpath-glob, qualname-glob, reason)]."""
    out: List[Tuple[str, str, str, str]] = []
    if not path.exists():
        return out
    for ln, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        head, sep, reason = line.partition("--")
        parts = head.split()
        if len(parts) != 3 or not sep:
            raise ValueError(
                f"{path}:{ln}: expected '<rule> <path> <qualname> -- "
                f"<reason>', got {raw!r}")
        out.append((parts[0], parts[1], parts[2], reason.strip()))
    return out


def _apply_waivers(findings: List[Finding],
                   file_waivers: Dict[str, Dict[int, Tuple[set, str]]],
                   repo_waivers: List[Tuple[str, str, str, str]]) -> None:
    for f in findings:
        per_line = file_waivers.get(f.path, {})
        for ln in (f.line, f.line - 1):
            entry = per_line.get(ln)
            if entry and (f.rule in entry[0] or "*" in entry[0]):
                f.waived = True
                f.waiver_reason = entry[1]
                break
        if f.waived:
            continue
        for rule, pglob, qglob, reason in repo_waivers:
            if (rule in (f.rule, "*")
                    and fnmatch.fnmatch(f.path, pglob)
                    and fnmatch.fnmatch(f.qualname, qglob)):
                f.waived = True
                f.waiver_reason = reason
                break


def run_checks(root: Path, rules: Iterable[Rule],
               waiver_file: Optional[Path] = None,
               package: str = PORT_PACKAGE,
               headline: Optional[Dict[str, str]] = None) -> List[Finding]:
    """Run ``rules`` over the repo at ``root``; returns findings with
    waivers applied (callers filter on ``waived`` to gate). An unparsable
    package file or a malformed waiver file raises: the CLI maps that to
    exit 2, never a silent pass."""
    rules = tuple(rules)
    ctx = RepoCtx(Path(root), package=package, headline=headline)
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.check(ctx))
    rule_ids = {r.id for r in rules}

    # waiver hygiene: empty justifications and unknown rule ids are
    # themselves findings
    for fc in ctx.files:
        for ln, (rids, reason) in fc.waivers.items():
            if not reason:
                findings.append(Finding(
                    "waiver", fc.rel, ln, fc.qualname_at(fc.tree),
                    "waiver without a justification (add '-- <reason>')"))
            unknown = rids - rule_ids - {"*", "waiver"}
            if unknown:
                findings.append(Finding(
                    "waiver", fc.rel, ln, "<module>",
                    f"waiver names unknown rule(s) {sorted(unknown)}"))
    repo_waivers = load_waivers(waiver_file) if waiver_file is not None else []
    _apply_waivers(findings, {fc.rel: fc.waivers for fc in ctx.files},
                   repo_waivers)
    # zero-waiver rules: a waived finding still gates, as a fresh
    # unwaived finding
    zero = {r.id for r in rules if r.zero_waiver}
    for f in list(findings):
        if f.waived and f.rule in zero:
            findings.append(Finding(
                "waiver", f.path, f.line, f.qualname,
                f"rule '{f.rule}' is zero-waiver (fix the finding: "
                f"{f.message})"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
