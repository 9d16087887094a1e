"""Fixture test file (bad root): asserts on a stats key and a tracer event
name no producer emits (the silent-drift class)."""


def test_ghost_surface(engine):
    assert engine.stats["ghost_key"] == 0
    assert list(engine.tracer.events("ghost_event")) == []
    assert "live_knob_prob" is not None  # fixture FaultPlan test mention


def test_live_surface(engine):
    engine.stats["test_written_key"] = 1
    assert engine.stats["test_written_key"] == 1
