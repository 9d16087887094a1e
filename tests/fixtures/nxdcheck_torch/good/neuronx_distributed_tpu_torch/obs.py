"""Fixture producer (good root): every name the fixture test consumes is
emitted here (registry literal, tracer wrapper, or f-string prefix)."""

STAT_KEYS = ("real_key",)


class Engine:
    def _trace_req(self, name, rid, **args):
        if self.tracer.enabled:
            self.tracer.instant(name, ("req", rid), args=args)

    def step(self):
        self.stats["real_key"] += 1
        self._trace_req("real_event", 0)
        self.tracer.instant(f"fault:{self.kind}", ("eng", "fault"))
