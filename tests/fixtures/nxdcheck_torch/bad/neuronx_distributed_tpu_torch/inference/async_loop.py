"""Known-bad fixture for async-contract, in the port's idiom: a pipelined
round that waits for the block it just replayed, and a dispatch that
blocks the host between replays."""

import time

import numpy as np
import torch


class ServeEngine:
    def _step_block_async(self):
        self._dispatch_block_async()
        # fetches the block it JUST dispatched: the pipeline collapses back
        # into the synchronous loop
        got = self._ring_host[self._ring_turn].numpy()
        for t in got.tolist():
            self._record(t)
        return True

    def _dispatch_block_async(self):
        out = self._dispatch("decode", lambda: self._fused(self.session))
        self._ring[:8].copy_(out.view(-1))
        torch.cuda.synchronize()       # waits for the replay it just made
        nxt = self._fetch(out)         # a direct blocking fetch
        self._tok = out[0].item()
        self._host = out.cpu()
        self._rows = np.asarray(nxt)
        time.sleep(0.001)
