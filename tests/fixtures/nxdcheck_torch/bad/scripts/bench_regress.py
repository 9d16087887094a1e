"""Fixture regress rule table (bad root): only the _ms pattern exists, so
the fixture bench's ``ghost_ratio`` headline key gates nothing."""

RULES = [
    (r".*_ms", "lower", 0.15),
]
