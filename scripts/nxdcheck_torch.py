#!/usr/bin/env python3
"""nxdcheck for the PyTorch/CUDA port: statically enforce the port's
contracts over its own code (host reads in captured programs, the capture
boundary copy, pin/release pairing, seeded decisions, surface drift, the
pipelined loop's blocking calls).

    python scripts/nxdcheck_torch.py [--json] [--rules ID,...] [--root PATH]
                                     [--waivers PATH] [--list]

Runs ``neuronx_distributed_tpu_torch.analysis`` (stdlib only; neither
``torch`` nor ``jax`` is imported: the package root loads its submodules
lazily). Findings go to stderr, one JSON summary is the last stdout line;
exit 0 = clean, 1 = unwaived findings, 2 = error.
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    try:
        from neuronx_distributed_tpu_torch.analysis.cli import main
    except Exception as e:  # noqa: BLE001 - an import failure is an internal error
        print(f"error: cannot import the analysis package: {e}", file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
