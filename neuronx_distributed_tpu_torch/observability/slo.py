"""Declarative SLOs with multi-window burn-rate alerting over the
metrics registry: the port's own copy of
``neuronx_distributed_tpu/observability/slo.py`` (stdlib only).

An SLO is a target over an observable: "99% of first tokens inside 50 ms"
(latency objective over a histogram) or "under 1% of admitted requests
expire" (error-ratio objective over two counters). The evaluation follows
the SRE-workbook discipline the big fleets converged on:

* the ERROR BUDGET is ``1 - target``; the BURN RATE is the observed error
  rate over a window divided by the budget (burn 1.0 = spending the budget
  exactly at the sustainable rate, burn N = exhausting it N times faster);
* alerts fire on a LONG window AND a SHORT window together (``BurnRule``):
  the long window keeps one bad block from paging anyone, the short window
  makes the alert RESET quickly once the incident ends — single-window
  threshold alerts fail one of the two, which is why multiwindow
  multi-burn-rate is the standard;
* two default rules: a fast-burn page (high factor, short windows) and a
  slow-burn ticket (low factor, long windows).

Windows are measured in VIRTUAL BLOCKS (the scheduler's deterministic
clock), so a chaos test can assert exact alert blocks. The monitor samples
cumulative (total, good) pairs from the registry once per block —
histograms are cumulative, so windowed rates are snapshot deltas; the
log-bucket edge below the objective is the conservative "good" count
(an observation inside the objective's covering bucket counts as BAD,
never the reverse — alerts can only over-fire, not under-fire).

Alert instants land on the tracer's ``(lane, "slo")`` track and a
``serve_slo_alerts_total{slo=...,rule=...}`` counter; a latched alert
re-fires only after the short-window burn drops back under the factor.
Disabled-by-default zero cost: an engine built without objectives never
constructs a monitor, and the monitor itself is a handful of host-side
reads per block — nothing touches a compiled program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from neuronx_distributed_tpu_torch.observability.metrics import (
    Histogram,
    MetricsRegistry,
)


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declarative objective. ``kind='latency'`` reads histogram
    ``metric`` and counts observations <= ``objective_ms`` as good;
    ``kind='error_ratio'`` reads counters ``bad`` / ``total`` (good =
    total - bad). ``target`` is the required good fraction."""

    name: str
    target: float
    kind: str = "latency"
    metric: str = ""
    objective_ms: float = 0.0
    bad: str = ""
    total: str = ""

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")
        if self.kind == "latency":
            if not self.metric or self.objective_ms <= 0:
                raise ValueError(
                    f"latency SLO {self.name!r} needs metric and "
                    f"objective_ms > 0")
        elif self.kind == "error_ratio":
            if not self.bad or not self.total:
                raise ValueError(
                    f"error_ratio SLO {self.name!r} needs bad and total "
                    f"counter names")
        else:
            raise ValueError(f"unknown SLO kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class BurnRule:
    """Alert when the burn rate exceeds ``factor`` over BOTH windows."""

    long_blocks: int
    short_blocks: int
    factor: float

    def __post_init__(self):
        if self.short_blocks < 1 or self.long_blocks < self.short_blocks:
            raise ValueError(
                f"need long_blocks >= short_blocks >= 1, got "
                f"{self.long_blocks}/{self.short_blocks}")
        if self.factor <= 0:
            raise ValueError(f"factor must be > 0, got {self.factor}")

    @property
    def label(self) -> str:
        return f"{self.long_blocks}b/{self.short_blocks}b x{self.factor:g}"


# fast-burn page + slow-burn ticket (block-clock scale of the tiny CPU
# harness; production deployments pass their own windows)
DEFAULT_RULES = (BurnRule(32, 4, 8.0), BurnRule(128, 16, 2.0))


def default_slos(ttft_ms: Optional[float] = None,
                 itl_ms: Optional[float] = None,
                 target: float = 0.95) -> List[SLObjective]:
    """The serving stack's stock objectives over the histograms/counters
    the engine always maintains: TTFT and inter-token latency targets plus
    a completion objective (expired streams are budget burn)."""
    out: List[SLObjective] = []
    if ttft_ms is not None:
        out.append(SLObjective(name="ttft", target=target,
                               metric="serve_ttft_ms", objective_ms=ttft_ms))
    if itl_ms is not None:
        out.append(SLObjective(name="itl", target=target,
                               metric="serve_itl_ms", objective_ms=itl_ms))
    out.append(SLObjective(name="completion", target=target,
                           kind="error_ratio", bad="serve_expired",
                           total="serve_inserted_requests"))
    return out


class SLOMonitor:
    """Per-block SLO evaluator over one :class:`MetricsRegistry`. Call
    :meth:`observe_block` once per scheduling round (the engine does, from
    ``_observe_block``); read :meth:`status` for the dashboard surface."""

    def __init__(self, registry: MetricsRegistry,
                 objectives: Sequence[SLObjective],
                 rules: Sequence[BurnRule] = DEFAULT_RULES,
                 tracer=None, lane: str = "engine"):
        if not objectives:
            raise ValueError("SLOMonitor needs at least one objective")
        self.registry = registry
        self.objectives = list(objectives)
        self.rules = list(rules)
        self.tracer = tracer
        self.lane = lane
        self._hist: Dict[str, List[Tuple[int, int, int]]] = {
            o.name: [] for o in self.objectives}
        self._latched: Dict[Tuple[str, str], bool] = {}
        self._keep = max(r.long_blocks for r in self.rules) + 1
        self.alerts: List[dict] = []
        self._m_alerts = {
            (o.name, r.label): registry.counter(
                "serve_slo_alerts_total", help="multi-window burn alerts",
                slo=o.name, rule=r.label)
            for o in self.objectives for r in self.rules}

    # --- sampling --------------------------------------------------------

    def _sample(self, o: SLObjective) -> Tuple[int, int]:
        """Cumulative (total, good) for one objective right now."""
        if o.kind == "latency":
            h = self.registry.histogram(o.metric)
            assert isinstance(h, Histogram)
            return h.count, h.count_le(o.objective_ms)
        bad = self.registry.counter(o.bad).value
        total = self.registry.counter(o.total).value
        return int(total), int(total) - int(bad)

    def _window(self, name: str, blocks: int) -> Tuple[int, int]:
        """(total, good) delta over the trailing ``blocks`` samples (the
        oldest available sample bounds a still-ramping window)."""
        hist = self._hist[name]
        _b, t1, g1 = hist[-1]
        i = max(len(hist) - 1 - blocks, 0)
        _b0, t0, g0 = hist[i]
        return t1 - t0, g1 - g0

    # --- evaluation ------------------------------------------------------

    def observe_block(self, block: int) -> List[dict]:
        """Sample every objective, evaluate every burn rule, record alert
        instants/counters for fresh violations. Returns the alerts raised
        at THIS block (empty list almost always)."""
        fired: List[dict] = []
        for o in self.objectives:
            total, good = self._sample(o)
            hist = self._hist[o.name]
            hist.append((int(block), total, good))
            if len(hist) > self._keep:
                del hist[: len(hist) - self._keep]
            budget = 1.0 - o.target
            for rule in self.rules:
                burns = []
                for w in (rule.long_blocks, rule.short_blocks):
                    dt, dg = self._window(o.name, w)
                    if dt <= 0:
                        burns = None
                        break
                    burns.append(((dt - dg) / dt) / budget)
                key = (o.name, rule.label)
                if burns is None:
                    continue
                violating = all(b > rule.factor for b in burns)
                if violating and not self._latched.get(key):
                    self._latched[key] = True
                    alert = {
                        "slo": o.name, "rule": rule.label, "block": int(block),
                        "burn_long": round(burns[0], 3),
                        "burn_short": round(burns[1], 3),
                        "factor": rule.factor, "target": o.target,
                    }
                    self.alerts.append(alert)
                    fired.append(alert)
                    self._m_alerts[key].inc()
                    if self.tracer is not None and self.tracer.enabled:
                        self.tracer.instant(
                            "slo_alert", (self.lane, "slo"), block=block,
                            args=dict(alert))
                elif not violating and burns[1] <= rule.factor:
                    # de-latch on the SHORT window: the incident is over,
                    # the next violation is a new alert
                    self._latched[key] = False
        return fired

    def latched(self) -> List[Tuple[str, str]]:
        """The (objective, rule-label) pairs alerting RIGHT NOW — the
        autoscaler's scale-up signal (the alert as an actuator). Sorted, so policy decisions keyed on it are
        deterministic given deterministic objectives."""
        return sorted(k for k, v in self._latched.items() if v)

    def alerting(self) -> bool:
        """True while any burn rule is latched (see :meth:`latched`)."""
        return any(self._latched.values())

    def status(self) -> dict:
        """Dashboard snapshot per objective: overall compliance, the
        current burn rate per rule window, and whether any rule is latched
        alerting right now."""
        out: Dict[str, dict] = {}
        for o in self.objectives:
            hist = self._hist[o.name]
            total, good = (hist[-1][1], hist[-1][2]) if hist else (0, 0)
            budget = 1.0 - o.target
            rules = {}
            for rule in self.rules:
                if not hist:
                    rules[rule.label] = None
                    continue
                dt, dg = self._window(o.name, rule.short_blocks)
                burn = (((dt - dg) / dt) / budget) if dt > 0 else None
                rules[rule.label] = {
                    "burn_short": round(burn, 3) if burn is not None else None,
                    "alerting": bool(self._latched.get((o.name, rule.label))),
                }
            out[o.name] = {
                "kind": o.kind,
                "target": o.target,
                "objective_ms": o.objective_ms or None,
                "observations": total,
                "compliance": round(good / total, 4) if total else None,
                "alerts": sum(1 for a in self.alerts if a["slo"] == o.name),
                "rules": rules,
            }
        return out
