"""Fixture producer (bad root): emits ONE stats key and ONE event (through
a tracer wrapper) so the observability-names check has producers; the
ghost names the fixture test asserts on are still unproduced."""

STAT_KEYS = ("real_key",)


class Engine:
    def _trace_req(self, name, rid, **args):
        if self.tracer.enabled:
            self.tracer.instant(name, ("req", rid), args=args)

    def step(self):
        self.stats["real_key"] += 1
        self._trace_req("real_event", 0)
        self.tracer.instant(f"fault:{self.kind}", ("eng", "fault"))
