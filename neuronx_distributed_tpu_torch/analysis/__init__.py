"""nxdcheck for the port: a stdlib-only static checker of the port's
serving and training contracts over its own code.

Usage (programmatic)::

    from neuronx_distributed_tpu_torch.analysis import ALL_RULES, run_checks
    findings = run_checks(repo_root, ALL_RULES, waiver_file=...)

or the CLI: ``python scripts/nxdcheck_torch.py --json`` (``python -m
neuronx_distributed_tpu_torch.analysis`` is the same). Nothing here
imports ``torch``, ``jax`` or the JAX package: it runs in a bare
interpreter in seconds.
"""

from .core import PORT_PACKAGE, Finding, RepoCtx, Rule, run_checks  # noqa: F401
from . import (async_contract, determinism, host_sync,  # noqa: F401
               replication, resource_pairing, surface_drift)

ALL_RULES = (
    host_sync.RULE,
    replication.RULE,
    resource_pairing.RULE,
    determinism.RULE,
    surface_drift.RULE,
    async_contract.RULE,
)

RULES_BY_ID = {r.id: r for r in ALL_RULES}
