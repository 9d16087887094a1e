"""Known-bad fixture for resource-pairing, in the port's idiom (one
``_release_pins`` over the ``*_pins`` maps): a seam that releases only one
pin, a completion that releases none, a page hold left exposed to a
dispatch failure, and a pool pin acquired without being recorded."""


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
        self._submit_ts.pop(rid, None)            # drops the request...
        self._adapter_pins.pop(rid, None)         # ...but keeps the grammar pin

    def _complete(self, comp):
        comp.tokens = self._out.pop(comp.request_id)   # no release at all

    def _admit_chunked(self, req, slot):
        st = self.session.paged.begin_chunked(req.prompt, 8)
        # dispatch while the hold is live and UNPROTECTED: a failed dispatch
        # leaks one admission's footprint (the storm class)
        logits = self._dispatch("extend", lambda: self.lm.extend(self.session, [slot], req))
        self.session.paged.finish_chunked(slot, st)
        return logits

    def _replay(self, req):
        for kind, pins in (("adapter", self._adapter_pins), ("grammar", self._grammar_pins)):
            name = getattr(req, kind)
            # pinned but never recorded: no seam can ever release it
            getattr(self.session, kind + "s").acquire(name)
