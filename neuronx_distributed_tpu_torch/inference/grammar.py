"""Structured decoding: grammar-constrained generation compiled to a
token-level DFA enforced inside the fused decode block (Outlines, Willard &
Louf 2023; XGrammar 2024).

Counterpart of ``neuronx_distributed_tpu/inference/grammar.py``. The
compiler is the port's own copy of the reference's numpy code, byte for
byte in its tables: a regular constraint (a regex of the supported subset,
or a JSON schema lowered to one) compiles ahead of time into a token DFA
over the vocabulary, a ``need (states, vocab)`` table (the budget a
transition still needs; ``_INF`` = forbidden) and a ``next (states,
vocab)`` table. Each decode step then masks with one row gather and two
compares (:func:`grammar_allowed`), the budget-aware guarantee: a stream
whose budget runs out is always in an accept state. A state that accepts
and has no allowed token is accept-terminal: landing there ends the stream
like EOS (``finish_reason="grammar_accept"``).

:class:`GrammarPool` holds the tables on the device: ``(slots, states,
vocab)`` int32 ``need`` and ``next`` and a ``(slots, states)`` ``terminal``
table, one set per ``CausalLM``, written in place (a captured decode block
reads them). Residency is the adapter pool's (``adapters.py``): refcounted
slots, LRU eviction of unpinned grammars, and slot 0 the identity grammar
(all-zero ``need``: every token allowed, logits untouched). Each acquire
checks the device tables against the registry by per-leaf sums reduced on
the device (only scalars cross to the host; JAX ``grammar.py:831``) and
repairs a corrupted slot (the ``grammar`` fault seam of ``faults.py``)
before the pin.

Sizing: one resident grammar is ``states * vocab * 8`` bytes plus
``states`` terminal bytes (:meth:`GrammarPool.grammar_bytes`).
"""

from __future__ import annotations

import time
import zlib
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neuronx_distributed_tpu_torch.inference.adapters import ResidentPool

# unreachable-accept sentinel: far above any real token distance, far below
# int32 overflow when the scan adds small offsets
_INF = np.int32(2 ** 30)


class GrammarCompileError(ValueError):
    """The pattern failed to compile to a completable token DFA (syntax
    error, no token sequence can ever match, or the DFA exceeds the pool's
    ``max_states``). Raised at ``register_grammar`` / submit time — never
    after device work started."""


class GrammarPoolExhausted(RuntimeError):
    """Every non-identity pool slot is pinned by an in-flight request and
    nothing is evictable — the admission is shed with a structured
    ``Rejected(reason="grammar_pool_exhausted")`` (pins return as streams
    retire)."""


class GrammarLoadError(RuntimeError):
    """A grammar table load failed (injected IO fault). Deterministic and
    retryable: the admission requeues and retries at a later block — the
    request is never decoded under a missing or half-written mask table."""


def default_token_table(vocab_size: int) -> Tuple[str, ...]:
    """Deterministic token-id → string table for vocabularies that have no
    real tokenizer attached (the synthetic-trace serving stack): id 0 is
    the pad token (empty string — never allowed by any grammar), ids 1..95
    are the printable ASCII characters, and the remaining ids cycle through
    two-character strings over ``[a-z0-9]`` so multi-character DFA walks
    are exercised. Real deployments pass their tokenizer's
    ``convert_ids_to_tokens`` strings instead."""
    table: List[str] = [""]
    table.extend(chr(c) for c in range(32, 127))
    alpha = "abcdefghijklmnopqrstuvwxyz0123456789"
    i = 0
    while len(table) < vocab_size:
        a, b = divmod(i, len(alpha))
        i += 1
        table.append(alpha[a % len(alpha)] + alpha[b])
    return tuple(table[:vocab_size])


def detokenize(token_ids: Sequence[int], table: Sequence[str]) -> str:
    """Token ids → text under a token table (the parse-oracle read path)."""
    return "".join(table[int(t)] for t in token_ids)


# --- regex subset: parser → Thompson NFA ---------------------------------
# A predicate is (chars, negated): the edge accepts c iff (c in chars) XOR
# negated. ``.`` is (frozenset(), True) — any char the token table can
# produce.

_Pred = Tuple[FrozenSet[str], bool]
_ESCAPES: Dict[str, _Pred] = {
    "d": (frozenset("0123456789"), False),
    "w": (frozenset(
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
        False),
    "s": (frozenset(" \t\n\r\f\v"), False),
}


class _NFA:
    """Thompson fragment collection: integer states, predicate edges and
    epsilon edges; one start, one final per build step."""

    def __init__(self):
        self.edges: List[Tuple[int, _Pred, int]] = []
        self.eps: List[Tuple[int, int]] = []
        self.n = 0

    def state(self) -> int:
        self.n += 1
        return self.n - 1


class _Parser:
    """Recursive-descent parser for the supported regex subset. Produces
    (start, final) fragments on one shared :class:`_NFA`."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.nfa = _NFA()

    def _err(self, msg: str) -> GrammarCompileError:
        return GrammarCompileError(
            f"regex error at position {self.i} in {self.p!r}: {msg}")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def take(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self) -> Tuple[int, int]:
        frag = self._alt()
        if self.i != len(self.p):
            raise self._err(f"unexpected {self.p[self.i]!r}")
        return frag

    def _alt(self) -> Tuple[int, int]:
        frags = [self._concat()]
        while self.peek() == "|":
            self.take()
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, f = self.nfa.state(), self.nfa.state()
        for fs, ff in frags:
            self.nfa.eps.append((s, fs))
            self.nfa.eps.append((ff, f))
        return s, f

    def _concat(self) -> Tuple[int, int]:
        frags = []
        while self.peek() is not None and self.peek() not in "|)":
            frags.append(self._repeat())
        if not frags:
            s = self.nfa.state()
            return s, s           # empty branch (e.g. "(a|)" or "")
        s, f = frags[0]
        for ns, nf in frags[1:]:
            self.nfa.eps.append((f, ns))
            f = nf
        return s, f

    def _repeat(self) -> Tuple[int, int]:
        frag = self._atom()
        while True:
            c = self.peek()
            if c == "*":
                self.take()
                frag = self._star(frag, plus=False)
            elif c == "+":
                self.take()
                frag = self._star(frag, plus=True)
            elif c == "?":
                self.take()
                frag = self._opt(frag)
            elif c == "{":
                frag = self._bounded(frag)
            else:
                return frag

    def _star(self, frag: Tuple[int, int], plus: bool) -> Tuple[int, int]:
        fs, ff = frag
        s, f = self.nfa.state(), self.nfa.state()
        self.nfa.eps += [(s, fs), (ff, f), (ff, fs)]
        if not plus:
            self.nfa.eps.append((s, f))
        return s, f

    def _opt(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        fs, ff = frag
        s, f = self.nfa.state(), self.nfa.state()
        self.nfa.eps += [(s, fs), (ff, f), (s, f)]
        return s, f

    def _bounded(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        # {m} / {m,} / {m,n} — implemented by re-parsing the atom the frag
        # came from would lose group structure, so the frag is CLONED via
        # state remapping instead
        start_i = self.i
        self.take()  # '{'
        spec = ""
        while self.peek() is not None and self.peek() != "}":
            spec += self.take()
        if self.peek() != "}":
            self.i = start_i
            raise self._err("unterminated {m,n} quantifier")
        self.take()
        parts = spec.split(",")
        try:
            lo = int(parts[0])
            hi = (lo if len(parts) == 1
                  else (None if parts[1] == "" else int(parts[1])))
        except ValueError:
            raise self._err(f"bad quantifier {{{spec}}}") from None
        if lo < 0 or (hi is not None and hi < lo):
            raise self._err(f"bad quantifier bounds {{{spec}}}")
        if hi is not None and hi == 0:
            s = self.nfa.state()
            return s, s
        clones = [frag] + [self._clone(frag)
                           for _ in range((hi or lo + 1) - 1)]
        if hi is None:
            clones.append(self._star(self._clone(frag), plus=False))
        s, f = self.nfa.state(), self.nfa.state()
        self.nfa.eps.append((s, clones[0][0]))
        for k in range(len(clones) - 1):
            self.nfa.eps.append((clones[k][1], clones[k + 1][0]))
        self.nfa.eps.append((clones[-1][1], f))
        # exits after each completed optional repetition (k >= lo)
        for k in range(max(lo, 1) - 1, len(clones)):
            self.nfa.eps.append((clones[k][1], f))
        if lo == 0:
            self.nfa.eps.append((s, f))
        return s, f

    def _clone(self, frag: Tuple[int, int]) -> Tuple[int, int]:
        """Deep-copy a fragment's reachable subgraph with fresh states."""
        fs, ff = frag
        # reachable states of the fragment
        adj: Dict[int, List[int]] = {}
        for a, _pr, b in self.nfa.edges:
            adj.setdefault(a, []).append(b)
        for a, b in self.nfa.eps:
            adj.setdefault(a, []).append(b)
        seen = {fs}
        stack = [fs]
        while stack:
            x = stack.pop()
            for y in adj.get(x, ()):
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        # sorted(): fresh state ids must not depend on set-iteration
        # order — the compiled table bytes (and their on-device digests)
        # have to be identical across processes for snapshot/replay
        remap = {x: self.nfa.state() for x in sorted(seen)}
        for a, pr, b in list(self.nfa.edges):
            if a in remap and b in remap:
                self.nfa.edges.append((remap[a], pr, remap[b]))
        for a, b in list(self.nfa.eps):
            if a in remap and b in remap:
                self.nfa.eps.append((remap[a], remap[b]))
        return remap[fs], remap.get(ff, remap[fs])

    def _atom(self) -> Tuple[int, int]:
        c = self.peek()
        if c is None:
            raise self._err("dangling quantifier or empty atom")
        if c == "(":
            self.take()
            frag = self._alt()
            if self.peek() != ")":
                raise self._err("unbalanced '('")
            self.take()
            return frag
        if c == "[":
            return self._edge(self._char_class())
        if c == ".":
            self.take()
            return self._edge((frozenset(), True))
        if c == "\\":
            self.take()
            return self._edge(self._escape())
        if c in "*+?{":
            raise self._err(f"quantifier {c!r} with nothing to repeat")
        if c in ")|":
            raise self._err(f"unexpected {c!r}")
        self.take()
        return self._edge((frozenset(c), False))

    def _escape(self) -> _Pred:
        if self.peek() is None:
            raise self._err("dangling escape")
        e = self.take()
        if e in _ESCAPES:
            return _ESCAPES[e]
        return (frozenset(e), False)     # \. \\ \[ \{ \" etc: literal

    def _char_class(self) -> _Pred:
        self.take()  # '['
        negated = False
        if self.peek() == "^":
            negated = True
            self.take()
        chars: set = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise self._err("unterminated character class")
            if c == "]" and not first:
                self.take()
                break
            first = False
            if c == "\\":
                self.take()
                pr = self._escape()
                if pr[1]:
                    raise self._err("negated escape inside class")
                chars |= set(pr[0])
                continue
            self.take()
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.take()
                hi = self.take()
                if hi == "\\":
                    hi = self.take()
                if ord(hi) < ord(c):
                    raise self._err(f"bad range {c}-{hi}")
                chars |= {chr(x) for x in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        return (frozenset(chars), negated)

    def _edge(self, pred: _Pred) -> Tuple[int, int]:
        s, f = self.nfa.state(), self.nfa.state()
        self.nfa.edges.append((s, pred, f))
        return s, f


def _pred_accepts(pred: _Pred, c: str) -> bool:
    chars, negated = pred
    return (c not in chars) if negated else (c in chars)


def _char_dfa(pattern: str, alphabet: Sequence[str]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Compile ``pattern`` to a dense char-DFA over ``alphabet``: returns
    (``next (S, A) int32`` with −1 = dead, ``accept (S,) bool``). Subset
    construction; state 0 is the start."""
    parser = _Parser(pattern)
    start, final = parser.parse()
    nfa = parser.nfa
    eps_adj: Dict[int, List[int]] = {}
    for a, b in nfa.eps:
        eps_adj.setdefault(a, []).append(b)
    edges_by_src: Dict[int, List[Tuple[_Pred, int]]] = {}
    for a, pr, b in nfa.edges:
        edges_by_src.setdefault(a, []).append((pr, b))

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        out = set(states)
        stack = list(states)
        while stack:
            x = stack.pop()
            for y in eps_adj.get(x, ()):
                if y not in out:
                    out.add(y)
                    stack.append(y)
        return frozenset(out)

    start_set = closure(frozenset([start]))
    ids: Dict[FrozenSet[int], int] = {start_set: 0}
    order = [start_set]
    rows: List[List[int]] = []
    accept: List[bool] = []
    qi = 0
    while qi < len(order):
        cur = order[qi]
        qi += 1
        accept.append(final in cur)
        row = []
        for c in alphabet:
            moved = {b for x in cur for pr, b in edges_by_src.get(x, ())
                     if _pred_accepts(pr, c)}
            if not moved:
                row.append(-1)
                continue
            nxt = closure(frozenset(moved))
            if nxt not in ids:
                ids[nxt] = len(order)
                order.append(nxt)
            row.append(ids[nxt])
        rows.append(row)
    return (np.asarray(rows, np.int32).reshape(len(order), len(alphabet)),
            np.asarray(accept, bool))


# --- JSON-schema subset → regex ------------------------------------------

_RE_SPECIALS = set("\\.[](){}|*+?^$-")


def regex_escape(s: str) -> str:
    """Escape ``s`` for literal use in this module's regex dialect."""
    return "".join("\\" + c if c in _RE_SPECIALS else c for c in s)


_STRING_RE = '"[^"\\\\]*"'          # no escapes/control chars: compact JSON
_INT_RE = "-?(0|[1-9][0-9]*)"
_NUMBER_RE = "-?(0|[1-9][0-9]*)(\\.[0-9]+)?"
_BOOL_RE = "(true|false)"


def json_schema_to_regex(schema: dict) -> str:
    """Lower the supported JSON-schema subset to a regex over COMPACT JSON
    (no whitespace, no string escapes — ``json.loads`` accepts every match).
    Supported: ``object`` (every listed property required, emitted in
    declaration order), ``string`` (optional ``enum``), ``integer``,
    ``number``, ``boolean``, ``array`` of any supported item type
    (``minItems``/``maxItems`` honored), and ``null``. Anything else raises
    :class:`GrammarCompileError`."""
    if not isinstance(schema, dict):
        raise GrammarCompileError(f"schema must be an object, got {schema!r}")
    t = schema.get("type")
    if "enum" in schema:
        vals = schema["enum"]
        if not vals or not all(isinstance(v, str) for v in vals):
            raise GrammarCompileError(
                "enum supports non-empty string lists only")
        return "(" + "|".join(f'"{regex_escape(v)}"' for v in vals) + ")"
    if t == "string":
        return _STRING_RE
    if t == "integer":
        return _INT_RE
    if t == "number":
        return _NUMBER_RE
    if t == "boolean":
        return _BOOL_RE
    if t == "null":
        return "null"
    if t == "array":
        item = json_schema_to_regex(schema.get("items", {"type": "string"}))
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if lo < 0 or (hi is not None and int(hi) < lo):
            raise GrammarCompileError("bad minItems/maxItems")
        if hi is not None:
            hi = int(hi)
            if hi == 0:
                return "\\[\\]"
            more = f"(,{item}){{{max(lo - 1, 0)},{hi - 1}}}"
            body = f"{item}{more}"
            return (f"\\[{body}\\]" if lo > 0
                    else f"(\\[\\]|\\[{body}\\])")
        body = f"{item}(,{item})*"
        if lo > 1:
            body = f"{item}(,{item}){{{lo - 1},}}"
        return (f"\\[{body}\\]" if lo > 0
                else f"(\\[\\]|\\[{body}\\])")
    if t == "object":
        props = schema.get("properties", {})
        if not props:
            return "\\{\\}"
        parts = [f'"{regex_escape(k)}":{json_schema_to_regex(v)}'
                 for k, v in props.items()]
        return "\\{" + ",".join(parts) + "\\}"
    raise GrammarCompileError(f"unsupported schema type {t!r}")


# --- token-level DFA ------------------------------------------------------


class CompiledGrammar:
    """One grammar's host-side token DFA: dense ``next (S, V) int32`` (−1 =
    forbidden), the derived ``mask``, per-state shortest token-distance to
    an accept state (``dist``, with budget-aware masking this is the
    termination guarantee), accept flags, and accept-terminal flags.
    State 0 is the start state."""

    def __init__(self, pattern: str, next_tok: np.ndarray,
                 accept: np.ndarray, compile_ms: float):
        self.pattern = pattern
        self.next = next_tok                      # (S, V) int32
        self.accept = accept                      # (S,) bool
        self.n_states, self.vocab = next_tok.shape
        self.compile_ms = compile_ms
        # token-level shortest distance to ANY accept state (BFS backward)
        dist = np.full((self.n_states,), _INF, np.int64)
        dist[accept] = 0
        succ = [np.unique(next_tok[s][next_tok[s] >= 0])
                for s in range(self.n_states)]
        changed = True
        while changed:
            changed = False
            for s in range(self.n_states):
                if len(succ[s]) == 0:
                    continue
                d = dist[succ[s]].min() + 1
                if d < dist[s]:
                    dist[s] = d
                    changed = True
        # transitions into never-accepting states are masked off: they can
        # only ever produce output that fails to parse
        dead = dist[np.clip(next_tok, 0, None)] >= _INF
        self.next = np.where((next_tok >= 0) & ~dead, next_tok, -1)
        self.mask = self.next >= 0                # (S, V) bool
        self.dist = np.minimum(dist, _INF).astype(np.int32)
        self.terminal = accept & ~self.mask.any(axis=1)
        self.min_tokens = int(self.dist[0])
        if self.min_tokens >= _INF:
            raise GrammarCompileError(
                f"grammar {pattern!r} matches no token sequence over this "
                f"token table")
        if self.min_tokens == 0 and not self.mask[0].any():
            raise GrammarCompileError(
                f"grammar {pattern!r} accepts only the empty string — a "
                f"decode stream must emit at least one token")
        # budget-aware allowed-token distance: dist[next[s, v]] (the scan
        # gathers this same quantity from the device dist table)
        self.dist_next = np.where(
            self.mask, self.dist[np.clip(self.next, 0, None)], _INF
        ).astype(np.int32)

    def allowed_row(self, state: int, remaining_after: int) -> np.ndarray:
        """The (V,) allowed mask from ``state`` with ``remaining_after``
        tokens of budget left AFTER the one about to be sampled — the exact
        boolean the device scan computes (budget-aware: only transitions
        that can still reach an accept state in time). Falls back to the
        plain mask if the budget-aware set empties (can only happen for
        rows the scheduler already froze)."""
        ok = self.mask[state] & (self.dist_next[state] <= remaining_after)
        return ok if ok.any() else self.mask[state]

    def walk(self, state: int, token_id: int) -> int:
        """One token transition (−1 = forbidden from this state)."""
        return int(self.next[state, int(token_id)])

    def fullmatch_ids(self, token_ids: Sequence[int]) -> bool:
        """Whether the token sequence drives start → accept (the parse
        oracle, evaluated on the DFA itself)."""
        s = 0
        for t in token_ids:
            s = int(self.next[s, int(t)])
            if s < 0:
                return False
        return bool(self.accept[s])


def compile_token_dfa(pattern: str, token_strs: Sequence[str],
                      json_schema: Optional[dict] = None) -> CompiledGrammar:
    """Compile a regex (or JSON schema, lowered first) against a token
    table into a :class:`CompiledGrammar`. The char-DFA is determinized
    over exactly the characters the token table can produce; the token
    composition is a vectorized walk of every token from every state."""
    t0 = time.perf_counter()
    if json_schema is not None:
        pattern = json_schema_to_regex(json_schema)
    alphabet = sorted({c for t in token_strs for c in t})
    if not alphabet:
        raise GrammarCompileError("token table produces no characters")
    char_ix = {c: i for i, c in enumerate(alphabet)}
    cnext, caccept = _char_dfa(pattern, alphabet)
    S = cnext.shape[0]
    V = len(token_strs)
    next_tok = np.full((S, V), -1, np.int32)
    # group tokens by length; one vectorized (S, n_tok) walk per group
    by_len: Dict[int, List[int]] = {}
    for v, t in enumerate(token_strs):
        if t:                         # empty tokens are never allowed
            by_len.setdefault(len(t), []).append(v)
    for L, vs in by_len.items():
        ids = np.asarray(
            [[char_ix.get(c, -1) for c in token_strs[v]] for v in vs],
            np.int64)                                   # (n, L)
        st = np.broadcast_to(np.arange(S, dtype=np.int64)[:, None],
                             (S, len(vs))).copy()        # (S, n)
        for j in range(L):
            cj = ids[:, j][None, :]                      # (1, n)
            stepped = np.where(
                cj >= 0,
                cnext[np.clip(st, 0, None), np.clip(cj, 0, None)], -1)
            st = np.where(st >= 0, stepped, -1)
        next_tok[:, vs] = st.astype(np.int32)
    ms = (time.perf_counter() - t0) * 1e3
    return CompiledGrammar(pattern, next_tok, caccept, round(ms, 3))


# --- device tables ----------------------------------------------------------

_LEAVES = ("need", "next", "terminal")


def grammar_tables(n_slots: int, max_states: int, vocab: int,
                   device=None) -> Dict[str, torch.Tensor]:
    """The device tables of a grammar pool, every slot the identity (see
    :func:`reset_grammar_tables`)."""
    tables = {"need": torch.empty((n_slots, max_states, vocab), dtype=torch.int32, device=device),
              "next": torch.empty((n_slots, max_states, vocab), dtype=torch.int32, device=device),
              "terminal": torch.empty((n_slots, max_states), dtype=torch.bool, device=device)}
    reset_grammar_tables(tables)
    return tables


def reset_grammar_tables(tables: Dict[str, torch.Tensor]) -> None:
    """In place: slot 0 the identity (``need`` 0: every token allowed under
    any budget), the other slots forbid everything until a grammar loads;
    ``next`` 0 and ``terminal`` False everywhere."""
    tables["need"][:1].zero_()
    tables["need"][1:].fill_(int(_INF))
    tables["next"].zero_()
    tables["terminal"].zero_()


def grammar_allowed(tables: Dict[str, torch.Tensor], gidx: torch.Tensor, gstate: torch.Tensor,
                    gbudget: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The (b, vocab) budget-aware allowed mask (JAX ``causal_lm.py:512``):
    row i takes token v iff ``need[gidx, gstate, v] <= gbudget - counts -
    1`` (the budget left after this token); when no token passes, the
    reachable set ``need < _INF`` (only rows already frozen). Identity rows
    (``gidx`` 0) are all True."""
    need = tables["need"][gidx.long(), gstate.long()]               # (b, V)
    ok = need <= (gbudget - counts - 1)[:, None]
    return torch.where(ok.any(-1, keepdim=True), ok, need < int(_INF))


class GrammarPool(ResidentPool):
    """Device-resident pool of ``n_slots`` compiled grammars padded to
    ``max_states`` over one vocabulary, on ``tables`` (a ``CausalLM``'s,
    or fresh ones on the CPU). One per session: the ``CausalLM`` resets
    the tables when a session starts. :meth:`register` compiles (host
    only), :meth:`acquire` loads, checks and pins, :meth:`release`
    unpins. ``fault_hook`` is the ``grammar`` seam of ``faults.py``;
    ``compiles`` counts registrations. ``vocab_shard`` ``(start, stop)``:
    the vocabulary columns the tables hold (a tensor-parallel rank's
    ``need``/``next`` shard); the DFA is compiled over the whole
    vocabulary and the slot holds those columns."""

    kind = "grammar"
    exhausted_error = GrammarPoolExhausted
    load_error = GrammarLoadError

    def __init__(self, n_slots: int, max_states: int, token_strs: Sequence[str],
                 tables: Optional[Dict[str, torch.Tensor]] = None,
                 vocab_shard: Optional[Tuple[int, int]] = None):
        if max_states < 2:
            raise ValueError(f"max_states must be >= 2, got {max_states}")
        token_strs = tuple(token_strs)
        self.vocab_shard = tuple(vocab_shard) if vocab_shard else (0, len(token_strs))
        width = self.vocab_shard[1] - self.vocab_shard[0]
        if tables is None:
            tables = grammar_tables(n_slots, max_states, width)
        if tuple(tables["need"].shape) != (n_slots, max_states, width):
            raise ValueError(f"tables {tuple(tables['need'].shape)} for {n_slots} slots, "
                             f"{max_states} states, vocab {len(token_strs)}")
        super().__init__(n_slots, tables["need"].device)
        self.max_states = int(max_states)
        self.token_strs = token_strs
        self.vocab = len(token_strs)
        self.tables = tables
        self.compiles = 0
        self._m_compile = None

    def attach_observability(self, tracer, metrics, block_fn=None) -> None:
        super().attach_observability(tracer, metrics, block_fn)
        self._m_compile = metrics.histogram(
            "grammar_compile_ms", help="regex/schema -> token-DFA compile wall ms", lo=0.01)

    def grammar(self, name: str) -> CompiledGrammar:
        return self._registry[name]["dfa"]

    def min_tokens(self, name: str) -> int:
        """Fewest generated tokens any match needs: ``submit(grammar=)``
        rejects smaller budgets."""
        return self._registry[name]["dfa"].min_tokens

    def compile_ms_of(self, name: str) -> float:
        return self._registry[name]["dfa"].compile_ms

    def grammar_bytes(self) -> int:
        """Device bytes one resident grammar takes: ``max_states * vocab *
        8`` (int32 need and next) plus ``max_states`` terminal bytes."""
        return sum(t[0].numel() * t.element_size() for t in self.tables.values())

    def register(self, name: str, regex: Optional[str] = None,
                 json_schema: Optional[dict] = None) -> CompiledGrammar:
        """Compile and store ``name``'s token DFA (host only). Exactly one of
        ``regex`` / ``json_schema``. Raises :class:`GrammarCompileError` on a
        bad pattern, an uncompletable grammar, or more states than the
        pool's ``max_states``."""
        if name in self._registry:
            raise ValueError(f"grammar {name!r} already registered")
        if (regex is None) == (json_schema is None):
            raise ValueError("register takes exactly one of regex= / json_schema=")
        dfa = compile_token_dfa(regex if regex is not None else "", self.token_strs,
                                json_schema=json_schema)
        if dfa.n_states > self.max_states:
            raise GrammarCompileError(f"grammar {name!r} compiles to {dfa.n_states} states, "
                                      f"pool max_states is {self.max_states}")
        view = self._host_slot_view(dfa)
        crc = 0
        for k in _LEAVES:
            crc = zlib.crc32(np.ascontiguousarray(view[k]).tobytes(), crc)
        self._registry[name] = {
            "dfa": dfa, "crc": crc,
            "host": {k: self._pinned(torch.from_numpy(view[k])) for k in _LEAVES},
            # per-leaf wraparound uint32 sums: the acquire-time digest,
            # reduced on the device
            "digest": {k: int(np.sum(view[k].astype(np.uint32), dtype=np.uint32))
                       for k in _LEAVES},
        }
        self.compiles += 1
        if self._m_compile is not None:
            self._m_compile.observe(dfa.compile_ms)
        self._note("grammar:compile", grammar=name, states=dfa.n_states, ms=dfa.compile_ms,
                   min_tokens=dfa.min_tokens)
        return dfa

    def _host_slot_view(self, dfa: CompiledGrammar) -> Dict[str, np.ndarray]:
        """The grammar in the device slot's padded layout: forbidden
        transitions stored as ``next`` 0 (``need`` is the mask's
        authority); padding states forbid everything."""
        S, V = self.max_states, self.vocab
        nxt = np.zeros((S, V), np.int32)
        nxt[: dfa.n_states] = np.clip(dfa.next, 0, None)
        need = np.full((S, V), _INF, np.int32)
        need[: dfa.n_states] = dfa.dist_next
        term = np.zeros((S,), bool)
        term[: dfa.n_states] = dfa.terminal
        lo, hi = self.vocab_shard
        return {"need": np.ascontiguousarray(need[:, lo:hi]),
                "next": np.ascontiguousarray(nxt[:, lo:hi]), "terminal": term}

    def _write_slot(self, slot: int, entry: dict) -> None:
        for k in _LEAVES:
            self.tables[k][slot].copy_(entry["host"][k], non_blocking=True)
        self._after_write(slot)

    def _garble_slot(self, slot: int) -> None:
        """Corrupt one entry of the slot's ``need`` and ``next`` tables (JAX
        ``grammar.py:861``): the mask that would let an out-of-grammar
        token through unless the check catches it."""
        self.tables["need"][slot, 0, 0] += 104729
        self.tables["next"][slot, 0, 0] += 7
        self._after_write(slot)

    def _device_digest(self, slot: int) -> Dict[str, int]:
        """Per-leaf sums of the device slot modulo 2**32, reduced on the
        device: three scalars cross to the host."""
        got = {}

        def read():
            sums = torch.stack([self.tables[k][slot].to(torch.int64).sum() for k in _LEAVES])
            got["sums"] = sums.to("cpu", non_blocking=self.device.type == "cuda")

        self._read_slot(slot, read)
        return {k: int(v) & 0xFFFFFFFF for k, v in zip(_LEAVES, got["sums"].tolist())}

    def _intact(self, slot: int, entry: dict) -> bool:
        return self._device_digest(slot) == entry["digest"]
