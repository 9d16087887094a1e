"""Prometheus-style metrics registry for the serving engine.

The port's own copy of ``neuronx_distributed_tpu/observability/metrics.py``,
stdlib only: the same instruments, the same exposition text and snapshot,
so a scrape of either engine reads the same way.

* :class:`Counter` — monotone event count;
* :class:`Gauge` — last-written level with its ``max`` (a batch run still
  reports its peak);
* :class:`Histogram` — log buckets (powers of ``growth`` from ``lo``): one
  ``log`` and one increment an observation, ``percentile`` the upper edge
  of the covering bucket (at most a ``growth`` factor high).

:meth:`MetricsRegistry.to_prometheus` writes the text exposition format,
:meth:`MetricsRegistry.snapshot` a JSON dict, and :func:`parse_prometheus`
reads the text back (label values escaped and unescaped).

Instruments are host arithmetic with no locks (the engine is one thread
between blocks) and never touch a device tensor.
"""

from __future__ import annotations

import json
import math
import re
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers stay integral, floats keep
    repr precision (so a snapshot -> parse -> snapshot round-trip is
    lossless)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int) or (isinstance(v, float) and v.is_integer()
                              and abs(v) < 2 ** 53):
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    """Prometheus exposition label-value escaping (backslash, quote,
    newline). Without it a label value containing a quote produces a line
    no conforming scraper — including :func:`parse_prometheus` — can read:
    a reader that follows the format."""
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _unescape_label(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _labels_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
    return "{" + inner + "}"


class Counter:
    """Monotone counter (``set`` mirrors a level kept elsewhere, such as
    the tracer's drop count; events should ``inc``)."""

    __slots__ = ("name", "labels", "_value")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0

    def inc(self, n=1) -> None:
        self._value += n

    def set(self, v) -> None:
        self._value = v

    @property
    def value(self):
        return self._value


class Gauge:
    __slots__ = ("name", "labels", "_value", "max")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._value = 0
        self.max = 0

    def set(self, v) -> None:
        self._value = v
        if v > self.max:
            self.max = v

    def inc(self, n=1) -> None:
        self.set(self._value + n)

    def dec(self, n=1) -> None:
        self._value -= n

    @property
    def value(self):
        return self._value


class Histogram:
    """Log-bucketed histogram: bucket i holds observations in
    ``(lo * growth**(i-1), lo * growth**i]``; bucket 0 is ``(-inf, lo]``,
    the last bucket is the +Inf overflow. ``percentile`` reports the upper
    edge of the covering bucket — a <= ``growth``-factor overestimate,
    honest for log-scale latency reporting."""

    __slots__ = ("name", "labels", "lo", "growth", "counts", "sum", "count")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 lo: float = 0.125, growth: float = 2.0, n_buckets: int = 24):
        if lo <= 0 or growth <= 1 or n_buckets < 2:
            raise ValueError(
                f"need lo > 0, growth > 1, n_buckets >= 2; got "
                f"{lo}/{growth}/{n_buckets}")
        self.name = name
        self.labels = labels
        self.lo = float(lo)
        self.growth = float(growth)
        self.counts = [0] * (n_buckets + 1)   # +1: the +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        if v <= self.lo:
            i = 0
        else:
            i = min(len(self.counts) - 1,
                    1 + int(math.log(v / self.lo) / math.log(self.growth)))
        self.counts[i] += 1

    def bucket_edges(self) -> List[float]:
        """Upper bounds per bucket (the final one is +inf)."""
        return [self.lo * self.growth ** i
                for i in range(len(self.counts) - 1)] + [math.inf]

    def count_le(self, v: float) -> int:
        """Observations provably <= ``v``: the cumulative count over
        buckets whose UPPER edge is <= v. An observation in v's covering
        bucket might exceed v, so it is excluded — a conservative lower
        bound (a 'good' count read from it can only under-count)."""
        total = 0
        for edge, c in zip(self.bucket_edges(), self.counts):
            if edge > v:
                break
            total += c
        return total

    def merged(self, *others: "Histogram") -> "Histogram":
        """Fresh histogram holding this one's counts plus ``others``'
        (bucket-wise — all inputs must share lo/growth/bucket count). The
        streaming fleet report's percentile source: per-replica latency
        histograms sum EXPLICITLY into one distribution (engines keep
        their own registries; nothing sums silently)."""
        out = Histogram(self.name, self.labels, lo=self.lo,
                        growth=self.growth, n_buckets=len(self.counts) - 1)
        for h in (self,) + tuple(others):
            if (h.lo, h.growth, len(h.counts)) != (
                    out.lo, out.growth, len(out.counts)):
                raise ValueError(
                    f"cannot merge histograms with different bucketing: "
                    f"{h.name} ({h.lo}/{h.growth}/{len(h.counts)}) vs "
                    f"{out.name} ({out.lo}/{out.growth}/{len(out.counts)})")
            out.counts = [a + b for a, b in zip(out.counts, h.counts)]
            out.sum += h.sum
            out.count += h.count
        return out

    def percentile(self, q: float) -> Optional[float]:
        """Upper edge of the bucket covering the q-th percentile (None when
        empty). The +Inf bucket reports the largest finite edge."""
        if not self.count:
            return None
        rank = q / 100.0 * self.count
        seen = 0
        edges = self.bucket_edges()
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return edges[i] if math.isfinite(edges[i]) else edges[-2]
        return edges[-2]


class MetricsRegistry:
    """Name+labels -> instrument store. ``counter``/``gauge``/``histogram``
    are get-or-create (idempotent, so call sites never coordinate); a name
    re-registered as a different kind raises — one exposition name must
    mean one thing."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], object] = {}
        self._kinds: Dict[str, type] = {}
        self._help: Dict[str, str] = {}

    def _get(self, cls, name: str, help_: str, labels: Dict[str, str],
             **kw):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        lab = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        key = (name, lab)
        known = self._kinds.get(name)
        if known is not None and known is not cls:
            raise ValueError(
                f"metric {name!r} already registered as {known.__name__}")
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, lab, **kw)
            self._metrics[key] = m
            self._kinds[name] = cls
            if help_:
                self._help[name] = help_
        return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", lo: float = 0.125,
                  growth: float = 2.0, n_buckets: int = 24,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         lo=lo, growth=growth, n_buckets=n_buckets)

    # --- export ----------------------------------------------------------

    def _families(self):
        fams: Dict[str, List[object]] = {}
        for (name, _lab), m in sorted(self._metrics.items()):
            fams.setdefault(name, []).append(m)
        return fams

    def to_prometheus(self) -> str:
        """Text exposition format (one scrape body / file drop). Histograms
        emit the standard cumulative ``_bucket{le=...}`` series plus
        ``_sum``/``_count``; gauges additionally emit ``<name>_max`` (the
        batch-run peak a scraper would otherwise miss)."""
        lines: List[str] = []
        for name, ms in self._families().items():
            kind = self._kinds[name]
            tname = {Counter: "counter", Gauge: "gauge",
                     Histogram: "histogram"}[kind]
            if name in self._help:
                lines.append(f"# HELP {name} {self._help[name]}")
            lines.append(f"# TYPE {name} {tname}")
            for m in ms:
                ls = _labels_str(m.labels)
                if kind is Histogram:
                    cum = 0
                    for edge, c in zip(m.bucket_edges(), m.counts):
                        cum += c
                        le = "+Inf" if math.isinf(edge) else _fmt(edge)
                        extra = tuple(m.labels) + (("le", le),)
                        lines.append(
                            f"{name}_bucket{_labels_str(extra)} {cum}")
                    lines.append(f"{name}_sum{ls} {_fmt(m.sum)}")
                    lines.append(f"{name}_count{ls} {m.count}")
                else:
                    lines.append(f"{name}{ls} {_fmt(m.value)}")
                    if kind is Gauge:
                        lines.append(f"{name}_max{ls} {_fmt(m.max)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able dump: {name: {kind, samples: [{labels, value | sum/
        count/buckets}]}} — the report-sidecar surface."""
        out: Dict[str, dict] = {}
        for name, ms in self._families().items():
            kind = self._kinds[name]
            fam = {"kind": {Counter: "counter", Gauge: "gauge",
                            Histogram: "histogram"}[kind],
                   "samples": []}
            if name in self._help:
                fam["help"] = self._help[name]
            for m in ms:
                s: dict = {"labels": dict(m.labels)}
                if kind is Histogram:
                    s.update(sum=m.sum, count=m.count,
                             buckets=[[("+Inf" if math.isinf(e) else e), c]
                                      for e, c in zip(m.bucket_edges(),
                                                      m.counts)],
                             p50=m.percentile(50), p99=m.percentile(99))
                elif kind is Gauge:
                    s.update(value=m.value, max=m.max)
                else:
                    s.update(value=m.value)
                fam["samples"].append(s)
            out[name] = fam
        return out

    def dump(self, path: str) -> None:
        """Write the exposition to ``path`` (``.json`` -> snapshot dict,
        anything else -> Prometheus text)."""
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump(self.snapshot(), f, indent=1)
        else:
            with open(path, "w") as f:
                f.write(self.to_prometheus())


# label values are quoted strings with backslash escapes, so a value may
# legally contain '}' or '"' — the sample regex must consume quoted
# sections atomically instead of stopping at the first brace
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(?:\{(?P<labels>(?:[^"}]|"(?:[^"\\]|\\.)*")*)\})?\s+(?P<value>\S+)$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, dict]:
    """Minimal exposition-format parser (:meth:`MetricsRegistry.to_prometheus`
    read back):
    returns {family: {"type": ..., "samples": {(sample_name, labels): float}}}.
    Raises ValueError on any malformed line."""
    fams: Dict[str, dict] = {}
    current: Optional[str] = None
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {ln}: malformed TYPE: {line!r}")
            current = parts[2]
            fams[current] = {"type": parts[3], "samples": {}}
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("#"):
            raise ValueError(f"line {ln}: unknown comment {line!r}")
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: malformed sample {line!r}")
        name = m.group("name")
        labels = tuple(sorted(
            (k, _unescape_label(v))
            for k, v in _LABEL_RE.findall(m.group("labels") or "")))
        raw = m.group("value")
        value = math.inf if raw == "+Inf" else float(raw)
        fam = None
        for base in (name, name.rsplit("_", 1)[0]):
            if base in fams:
                fam = fams[base]
                break
        if fam is None:
            raise ValueError(f"line {ln}: sample {name!r} precedes its TYPE")
        fam["samples"][(name, labels)] = value
    return fams
