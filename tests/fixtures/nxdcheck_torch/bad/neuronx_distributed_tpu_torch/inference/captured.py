"""Known-bad fixture for host-sync and cache-replication, in the port's
idiom: captured bodies that read device values on the host, and callers
that hand back a graph's own output buffers. Every construct here must keep
firing its rule (tests/test_torch_analysis.py pins it)."""

import numpy as np
import torch

from .model_builder import CapturedProgram, _clone_out


class FusedDecode:
    def __init__(self, lm, steps):
        self.lm, self.steps = lm, steps
        self.out = torch.zeros((steps + 1, 8), dtype=torch.int32)
        self.program = CapturedProgram(self._body, lm.device)

    def _body(self):
        st = self.lm.slots
        f = st.dev_field
        done = f("done") != 0
        tok = f("tok")
        if done.any():                 # Python branch on a device value
            tok = tok + 1
        n = int(tok.sum())             # coercion reads the device
        for row in tok:                # Python iteration over a device value
            self._note(row)
        host = np.asarray(tok)         # host materialization in a capture
        first = tok[0].item()          # device->host read per step
        print(tok)                     # formats a device value on the host
        self.out[0] = tok.cpu()        # copy to the host
        del n, host, first

    def _note(self, row):
        # reached through self.: it runs under the capture too
        torch.cuda.synchronize()


def build_decode(lm):
    def body(ids):
        logits = lm.model(ids)
        while logits.max() > 0:        # loop on a device value
            logits = logits - 1
        return logits.to("cpu")        # a host copy inside the program
    return CapturedProgram(body, lm.device)


def capture_by_hand(graph, fn, static_in):
    with torch.cuda.graph(graph):
        out = fn(static_in)
        rows = out.tolist()            # a host read while the graph records
    return out, rows


class Runner:
    def __init__(self, prog):
        self.prog = prog

    def __call__(self, *args):
        self.prog._load(args)
        return self.prog.replay()      # the graph's own buffers leave raw

    def keep(self):
        out = self.prog.replay()
        self.last = out                # stored on self, overwritten next replay

    def peek(self):
        return self.prog.static_out[0]

    def fetch(self):
        self.prog.replay()
        return self.buf                # a buffer the graph writes, not blessed

    def safe(self):
        return _clone_out(self.prog.replay())
