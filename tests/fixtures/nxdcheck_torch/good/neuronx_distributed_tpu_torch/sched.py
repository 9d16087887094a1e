"""Known-good fixture for determinism: the blessed counterparts: the block
clock and perf_counter for measurement, seeded streams (numpy and torch),
ordered or order-free set use."""

import time

import numpy as np
import torch


class Scheduler:
    def __init__(self, seed=0):
        self._open = set()
        self._tenants: set = set()
        self._rs = np.random.RandomState(seed)  # seeded stream: legal
        self._gen = torch.Generator().manual_seed(seed)

    def pick(self, candidates, blocks):
        wall_ms = time.perf_counter()           # measurement, not decision
        draw = self._rs.random_sample()
        u = torch.rand(4, generator=self._gen)
        w = torch.empty(4).normal_(generator=self._gen)
        deferred = set(candidates)
        if 3 in deferred:                       # membership: order-free
            return 3
        n = len(self._tenants)                  # reduction: order-free
        for t in sorted(self._tenants):         # sorted iteration: legal
            return t, wall_ms, draw, n, blocks, u, w
        return sorted(self._open)
