"""Known-good fixture: the same program shapes as the bad twin, written the
way the port writes them: configuration branching, static projections,
device-side selects, and every graph output leaving through ``_clone_out``
(or the blessed ``FusedDecode.out``). Must stay CLEAN under host-sync and
cache-replication (the rules' false-positive pin)."""

import torch

from .model_builder import CapturedProgram, _clone_out


class FusedDecode:
    def __init__(self, lm, steps):
        self.lm, self.steps = lm, steps
        self.out = torch.zeros((steps + 1, 8), dtype=torch.int32)
        self.program = CapturedProgram(self._body, lm.device)

    def _body(self):
        lm = self.lm
        st = lm.slots
        f = st.dev_field
        done = f("done") != 0
        tok = f("tok")
        tables = lm.grammar_tables
        if tables is not None:             # configuration: legal
            tok = torch.where(done, tok, tok + 1)
        if lm.lora:                        # configuration through self.: legal
            tok = tok + 0
        b = tok.shape[0]                   # static projection: legal
        for i in range(self.steps):        # a static trip count: legal
            self.out[i] = torch.where(done, 0, tok)
        self.out[self.steps] = torch.full((b,), 1, dtype=torch.int32)
        f("tok").copy_(tok)

    def __call__(self, session):
        self.program.replay()
        return self.out                    # the blessed buffer


def build_decode(lm, greedy):
    def body(ids, *adapter):
        logits = lm.model(ids)
        if greedy:                         # closure configuration: legal
            return torch.argmax(logits, -1)
        if adapter:                        # vararg emptiness: static
            logits = logits + 0
        return logits
    return CapturedProgram(body, lm.device)


def capture_by_hand(graph, fn, static_in):
    with torch.cuda.graph(graph):
        out = fn(static_in)
    return out


class Runner:
    def __init__(self, prog):
        self.prog = prog

    def __call__(self, *args):
        self.prog._load(args)
        return _clone_out(self.prog.replay())

    def keep(self):
        out = _clone_out(self.prog.replay())
        self.last = out
