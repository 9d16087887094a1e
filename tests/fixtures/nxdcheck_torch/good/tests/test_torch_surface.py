"""Fixture test file (good root): consumes only names a producer emits
(registry literal, tracer wrapper, f-string prefix, or the test itself)."""


def test_real_surface(engine):
    assert engine.stats["real_key"] >= 0
    assert list(engine.tracer.events("real_event")) is not None
    assert list(engine.tracer.events("fault:dispatch")) is not None
    assert "live_knob_prob" is not None  # fixture FaultPlan test mention


def test_own_surface(engine, tracer):
    engine.stats["test_written_key"] = 1
    tracer.instant("test_emitted", ("t", "t"))
    assert engine.stats["test_written_key"] == 1
    assert list(tracer.events("test_emitted")) is not None
