"""Known-good fixture bench surface: every gating key has a regress rule,
a producing store, and a place in the newest artifact."""

HEADLINE_KEYS = (
    "serve_present_ms",
    "bench_error",
)


def run():
    out = {}
    out["serve_present_ms"] = 1.5
    return out
