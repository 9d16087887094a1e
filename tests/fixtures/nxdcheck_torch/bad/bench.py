"""Known-bad fixture bench surface: ``ghost_ratio`` matches no regress rule
(silently ungated), ``serve_thing_ms`` is declared but absent from the
artifact, and no serving key has a producing store."""

HEADLINE_KEYS = (
    "ghost_ratio",
    "serve_thing_ms",
    "serve_present_ms",
    "bench_error",
)
