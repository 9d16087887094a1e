"""Fixture fault plan (good root): every probability knob has an injector
read and a test mention."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    seed: int = 0
    live_knob_prob: float = 0.0


class FaultInjector:
    def __init__(self, plan):
        self.plan = plan

    def roll(self):
        return self.plan.live_knob_prob > 0
