"""Known-good fixture for async-contract: the same pipelined round written
with the port's discipline: the async-named path only replays and queues
a non-blocking copy behind an event; the one blocking wait lives in the
harvest helpers, after the next block is in flight."""

import torch


class ServeEngine:
    def _step_block_async(self):
        self._dispatch_block_async()
        self._harvest_inflight()
        return True

    def _dispatch_block_async(self):
        out = self._dispatch("decode", lambda: self._fused(self.session))
        self._ring[:8].copy_(out.view(-1))
        self._ring_host[self._ring_turn].copy_(self._ring, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._inflight.append({"turn": self._ring_turn, "event": event})

    def _harvest_inflight(self):
        while len(self._inflight) > 1:
            self._harvest_rec(self._inflight.popleft())

    def _harvest_rec(self, rec):
        rec["event"].synchronize()
        got = self._ring_host[rec["turn"]].numpy().copy()
        for t in got.tolist():
            self._record(t)
