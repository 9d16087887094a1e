"""Known-good fixture for resource-pairing: the same seams written with the
port's discipline: ``_release_pins`` at every seam (directly or by
delegation), assert-absence witnesses, try/except rollback around
dispatches, pins recorded at acquire (through local aliases too)."""


class ServeEngine:
    def __init__(self):
        self._adapter_pins = {}
        self._grammar_pins = {}

    def _release_pins(self, rid):
        name = self._adapter_pins.pop(rid, None)
        if name is not None:
            self.session.adapters.release(name)
        name = self._grammar_pins.pop(rid, None)
        if name is not None:
            self.session.grammars.release(name)

    def cancel(self, rid):
        self._submit_ts.pop(rid, None)
        self._release_pins(rid)

    def _complete(self, comp):
        # delegation counts: the seam reaches the release through a helper
        self._unpin(comp.request_id)
        comp.tokens = self._out.pop(comp.request_id)

    def _unpin(self, rid):
        self._release_pins(rid)

    def _handoff(self, rid):
        # a seam may PROVE a pin cannot exist instead of releasing it
        self._out.pop(rid, None)
        assert rid not in self._adapter_pins and rid not in self._grammar_pins

    def _admit_chunked(self, req, slot):
        st = self.session.paged.begin_chunked(req.prompt, 8)
        try:
            logits = self._dispatch("extend", lambda: self.lm.extend(self.session, [slot], req))
        except BaseException:
            self.session.paged.abort_chunked(slot, st)
            raise
        self.session.paged.finish_chunked(slot, st)
        return logits

    def _replay(self, req):
        for kind, pins in (("adapter", self._adapter_pins), ("grammar", self._grammar_pins)):
            name = getattr(req, kind)
            getattr(self.session, kind + "s").acquire(name)
            pins[req.request_id] = name

    def _pin(self, req, kind):
        pins = self._adapter_pins if kind == "adapter" else self._grammar_pins
        pool = self.session.adapters if kind == "adapter" else self.session.grammars
        slot = pool.acquire(getattr(req, kind))
        pins[req.request_id] = getattr(req, kind)
        return slot
