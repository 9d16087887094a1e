#!/usr/bin/env python3
"""Time B5 (the W8A16 GEMM) of one checkout at this checkout's cases, for
comparing two versions of the kernel on one card.

    python3 scripts/w8a16_ab.py TREE

``TREE`` is the root of a checkout (this repository, or an older commit
unpacked with ``git archive``). The script imports ``chip_smoke`` and the
port from ``TREE``, hands its ``run_w8a16`` the case list of the
``chip_smoke.py`` beside this script (so an older kernel is held and timed
at cases its own smoke lacks), and prints one line ``AB {json}``: per case
the kernel's ms, the bf16 ``torch.matmul`` yardstick's ms and their ratio,
the share of the bound, and the route and tile where the tree has routes.
The harness (the import from ``TREE``, the ``AB`` line) is
``torch_ab.run_ab``. Run it once per checkout in turns (A, B, B, A) in one
call: two machines may carry cards that differ. Exits 1 without a GPU.
"""

import ast
import sys
from pathlib import Path

from torch_ab import run_ab

HERE = Path(__file__).resolve().parents[1]


def cases_here() -> tuple:
    """``W8A16_CASES`` of this checkout's ``chip_smoke.py``, read without
    importing it (the other tree's module takes that name)."""
    tree = ast.parse((HERE / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "W8A16_CASES" for t in node.targets):
            return ast.literal_eval(node.value)
    raise SystemExit("chip_smoke.py has no W8A16_CASES")


def timed_cases(cs) -> dict:
    """``cs.run_w8a16`` at this checkout's cases, per case the numbers the
    A/B compares."""
    import torch

    cs.W8A16_CASES = cases_here()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    r = cs.run_w8a16("cuda", flush)
    return dict(cases={
        case: dict(ms=t["ms"], library_ms=t["library_ms"], ratio=t["ms"] / t["library_ms"],
                   bound_ms=t["bound_ms"], bound_share=t["bound_ms"] / t["ms"],
                   route=t.get("route"), tile=t.get("tile"), splits=t.get("splits"))
        for case, t in r["cases"].items()})


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(run_ab(sys.argv[1], timed_cases))
