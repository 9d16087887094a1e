"""Fixture fault plan (bad root): ``dead_knob_prob`` is read by no
injector and named by no test: dead chaos coverage."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    seed: int = 0
    live_knob_prob: float = 0.0
    dead_knob_prob: float = 0.0


class FaultInjector:
    def __init__(self, plan):
        self.plan = plan

    def roll(self):
        return self.plan.live_knob_prob > 0
