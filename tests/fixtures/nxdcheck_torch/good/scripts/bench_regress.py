"""Fixture regress rule table (good root)."""

RULES = [
    (r".*_ms", "lower", 0.15),
]
