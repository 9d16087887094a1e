"""nxdcheck CLI for the port: statically enforce its contracts.

    python scripts/nxdcheck_torch.py [--json] [--rules host-sync,determinism]
                                     [--root PATH] [--waivers PATH] [--list]

Output protocol: human-readable finding lines on stderr, ONE compact JSON
summary as the last stdout line (``rules``, ``findings``, ``unwaived``,
``waived``, ``by_rule``, ``elapsed_s``, ``verdict``; ``--json`` adds the
full findings list above it). Exit 0 = clean (no unwaived findings), 1 =
unwaived findings, 2 = internal or usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import ALL_RULES, RULES_BY_ID
from .core import PORT_PACKAGE, run_checks

HEADLINE_NOTE = ("surface-drift's headline-* sub-checks run only when a caller names a "
                 "bench (run_checks(headline=...)); the port has no bench yet")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the port's static contract checker (exit 1 on unwaived findings)")
    ap.add_argument("--json", action="store_true",
                    help="print the full findings list as JSON on stdout")
    ap.add_argument("--root", default=None,
                    help="repo root (default: the checkout this package lies in)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--waivers", default=None,
                    help=f"waiver file (default: {PORT_PACKAGE}/analysis/waivers.txt "
                         f"under the root)")
    ap.add_argument("--list", action="store_true", help="list rules and exit")
    args = ap.parse_args(argv)

    if args.list:
        for r in ALL_RULES:
            gate = " [zero-waiver]" if r.zero_waiver else ""
            print(f"{r.id}{gate}: {r.doc}")
        print(f"note: {HEADLINE_NOTE}")
        print(json.dumps({"rules": [r.id for r in ALL_RULES]}))
        return 0

    root = Path(args.root) if args.root else Path(__file__).resolve().parents[2]
    rules = ALL_RULES
    if args.rules:
        try:
            rules = tuple(RULES_BY_ID[rid.strip()]
                          for rid in args.rules.split(",") if rid.strip())
        except KeyError as e:
            print(f"error: unknown rule {e} (known: {sorted(RULES_BY_ID)})",
                  file=sys.stderr)
            return 2
    waiver_file = (Path(args.waivers) if args.waivers
                   else root / PORT_PACKAGE / "analysis" / "waivers.txt")

    t0 = time.perf_counter()
    try:
        findings = run_checks(root, rules, waiver_file=waiver_file)
    except (SyntaxError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    elapsed = time.perf_counter() - t0

    unwaived = [f for f in findings if not f.waived]
    for f in findings:
        tag = "waived" if f.waived else "FINDING"
        reason = f" (waiver: {f.waiver_reason})" if f.waived else ""
        print(f"[{tag}] {f.rule} {f.path}:{f.line} {f.qualname}: "
              f"{f.message}{reason}", file=sys.stderr)
    by_rule = {}
    for f in unwaived:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    if args.json:
        print(json.dumps({"findings": [f.as_dict() for f in findings]}, indent=1))
    print(json.dumps({
        "rules": [r.id for r in rules],
        "findings": len(findings),
        "unwaived": len(unwaived),
        "waived": len(findings) - len(unwaived),
        "by_rule": by_rule,
        "elapsed_s": round(elapsed, 3),
        "verdict": "clean" if not unwaived else "findings",
    }))
    return 0 if not unwaived else 1
