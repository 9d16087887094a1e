"""Known-bad fixture for determinism: wall-clock reads, unseeded module
RNG, torch's global generator and bare-set iteration in decision code."""

import random
import time

import numpy as np
import torch


class Scheduler:
    def __init__(self):
        self._open = set()
        self._tenants: set = set()

    def pick(self, candidates):
        now = time.time()                      # wall clock in a decision
        jitter = random.random()               # unseeded module-level rng
        noise = np.random.uniform()            # unseeded np global stream
        u = torch.rand(4)                      # torch's global generator
        torch.manual_seed(0)                   # reseeds the global stream
        w = torch.empty(4).normal_()           # in-place draw, no generator=
        deferred = set(candidates)
        for i in deferred:                     # bare-set iteration (local)
            return i, now, jitter, noise, u, w
        for t in self._tenants:                # bare-set iteration (attr)
            return t
        return [x for x in self._open]         # comprehension over a set
