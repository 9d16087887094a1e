"""Incident flight recorder: bounded, schema-validated evidence bundles
dumped at the moment something goes wrong. The port's own copy of
``neuronx_distributed_tpu/observability/incident.py`` (stdlib only): a
bundle written by either package passes either validator.

The ring-buffer tracer answers post-hoc questions — IF the operator
exports it before the window scrolls away. An incident at block 400 of a
long run is gone by the time anyone looks. The flight recorder closes that
gap the way avionics do: trigger hooks at the failure seams the engine
already detects (deadline-miss burst, page corruption, pool-exhaustion
storm, dispatch fail-stop, replica crash) ATOMICALLY dump a bundle with
everything a diagnosis needs:

* the TRACE SLICE around the trigger block (bounded event count — the
  window that would otherwise scroll out of the ring buffer);
* the full METRICS snapshot (cumulative counters/gauges/histograms);
* an engine/router STATE SUMMARY (queue, slots, pool, tier residency);
* the SLO status when a monitor is armed, plus trigger details.

Bundles are bounded three ways: ``max_events`` caps the slice,
``max_bundles`` caps files per run (a crash loop must not fill the disk),
and ``min_gap_blocks`` rate-limits per trigger kind (a 50-block storm is
one incident, not 50). Writes are tmp+rename atomic — a reader never sees
a half bundle. :func:`validate_incident_bundle` is the schema gate the
tier-1 smoke runs on every produced file, same discipline as
``validate_chrome_trace``.

Zero-cost contract: an engine without ``incident_dir`` never constructs a
recorder; an armed recorder costs one deque scan per TRIGGER (not per
block), and nothing here is visible to a compiled program.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

INCIDENT_SCHEMA_VERSION = 1

# the trigger vocabulary; validate_incident_bundle rejects unknown kinds so
# a typo'd trigger cannot silently produce an unclassifiable bundle
INCIDENT_KINDS = (
    "deadline_miss_burst",
    "page_corruption",
    "pool_exhaustion_storm",
    "dispatch_failstop",
    "replica_crash",
    "slo_burn",
    # autoscaler fleet mutations: capacity changes pinned next
    # to the burn alerts / backlog that caused them
    "scale",
    "manual",
)


class FlightRecorder:
    """One recorder per serving process (engines of one Router share it so
    a replica-crash bundle sees the whole fleet's timeline)."""

    def __init__(self, out_dir: str, tracer=None, metrics=None, *,
                 window_blocks: int = 16, max_events: int = 2000,
                 max_bundles: int = 16, min_gap_blocks: int = 8,
                 source: str = "engine"):
        if window_blocks < 1:
            raise ValueError(f"window_blocks must be >= 1, got {window_blocks}")
        if max_events < 1 or max_bundles < 1:
            raise ValueError("max_events and max_bundles must be >= 1")
        self.out_dir = str(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.tracer = tracer
        self.metrics = metrics
        self.window_blocks = int(window_blocks)
        self.max_events = int(max_events)
        self.max_bundles = int(max_bundles)
        self.min_gap_blocks = int(min_gap_blocks)
        self.source = str(source)
        self.bundles: List[str] = []
        self.suppressed = 0
        self._last_block: dict = {}

    # --- trace slice -----------------------------------------------------

    def _slice(self, block: int) -> dict:
        """Events inside [block - window, block] on the virtual clock
        (blockless events — cache instants recorded outside a block context
        — ride along), newest kept when the cap bites."""
        if self.tracer is None:
            return {"events": [], "dropped_ring_events": 0, "truncated": False}
        lo = block - self.window_blocks
        picked = []
        for ev in self.tracer.events():
            b = ev["block"]
            if b is None or lo <= b <= block:
                picked.append({
                    "name": ev["name"], "ph": ev["ph"],
                    "lane": list(ev["lane"]), "ts": ev["ts"],
                    "block": b, "dur": ev.get("dur"),
                    "args": ev["args"],
                })
        truncated = len(picked) > self.max_events
        if truncated:
            picked = picked[-self.max_events:]
        return {"events": picked,
                "dropped_ring_events": self.tracer.dropped,
                "truncated": truncated}

    # --- triggering ------------------------------------------------------

    def trigger(self, kind: str, block: int, *, details: Optional[dict] = None,
                state: Optional[dict] = None,
                slo: Optional[dict] = None) -> Optional[str]:
        """Dump one bundle for ``kind`` at ``block``; returns the written
        path, or None when rate-limited (per-kind gap) or capped (bundle
        budget spent). Never raises into the serving loop: a failed write
        is counted and swallowed — the incident path must not become an
        incident."""
        if kind not in INCIDENT_KINDS:
            raise ValueError(f"unknown incident kind {kind!r} "
                             f"(known: {INCIDENT_KINDS})")
        last = self._last_block.get(kind)
        if last is not None and block - last < self.min_gap_blocks:
            self.suppressed += 1
            return None
        if len(self.bundles) >= self.max_bundles:
            self.suppressed += 1
            return None
        self._last_block[kind] = int(block)
        bundle = {
            "schema_version": INCIDENT_SCHEMA_VERSION,
            "kind": kind,
            "block": int(block),
            "wall_time": time.time(),
            "source": self.source,
            "details": details or {},
            "state": state or {},
            "trace": self._slice(int(block)),
            "metrics": (self.metrics.snapshot()
                        if self.metrics is not None else None),
            "slo": slo,
        }
        seq = len(self.bundles)
        path = os.path.join(self.out_dir,
                            f"incident_{seq:03d}_{kind}_b{int(block)}.json")
        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f)
            os.replace(tmp, path)
        except OSError:
            self.suppressed += 1
            return None
        self.bundles.append(path)
        return path


def validate_incident_bundle(doc) -> dict:
    """Schema gate for one bundle (dict or file path): version, known kind,
    required sections, well-formed trace slice (every event carries
    name/ph/lane, blocks inside the declared window), JSON-able metrics
    snapshot shape. Returns a summary dict; raises ``ValueError`` on the
    first violation — the tier-1 smoke's contract."""
    if isinstance(doc, (str, os.PathLike)):
        with open(doc) as f:
            doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError("incident bundle must be a JSON object")
    if doc.get("schema_version") != INCIDENT_SCHEMA_VERSION:
        raise ValueError(
            f"unknown schema_version {doc.get('schema_version')!r}")
    if doc.get("kind") not in INCIDENT_KINDS:
        raise ValueError(f"unknown incident kind {doc.get('kind')!r}")
    if not isinstance(doc.get("block"), int):
        raise ValueError("bundle missing integer 'block'")
    for field in ("details", "state", "trace"):
        if not isinstance(doc.get(field), dict):
            raise ValueError(f"bundle missing object field {field!r}")
    tr = doc["trace"]
    evs = tr.get("events")
    if not isinstance(evs, list):
        raise ValueError("trace.events must be a list")
    names = set()
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"trace event {i} is not an object")
        if not isinstance(ev.get("name"), str) or not isinstance(
                ev.get("ph"), str):
            raise ValueError(f"trace event {i} missing name/ph: {ev}")
        lane = ev.get("lane")
        if not (isinstance(lane, list) and len(lane) == 2):
            raise ValueError(f"trace event {i} missing 2-element lane: {ev}")
        b = ev.get("block")
        if b is not None and not isinstance(b, int):
            raise ValueError(f"trace event {i} has non-integer block: {ev}")
        if isinstance(b, int) and b > doc["block"]:
            raise ValueError(
                f"trace event {i} postdates the trigger block: {ev}")
        names.add(ev["name"])
    metrics = doc.get("metrics")
    if metrics is not None:
        if not isinstance(metrics, dict):
            raise ValueError("metrics snapshot must be an object")
        for fam, body in metrics.items():
            if not (isinstance(body, dict) and "kind" in body
                    and isinstance(body.get("samples"), list)):
                raise ValueError(f"malformed metrics family {fam!r}")
    return {
        "kind": doc["kind"],
        "block": doc["block"],
        "events": len(evs),
        "truncated": bool(tr.get("truncated", False)),
        "names": names,
        "has_metrics": metrics is not None,
        "has_slo": doc.get("slo") is not None,
    }
