"""``python -m neuronx_distributed_tpu_torch.analysis``: the nxdcheck CLI
(:mod:`.cli`)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
