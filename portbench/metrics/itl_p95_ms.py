"""p95 over every gap between two consecutive tokens of a request, for
every token emitted in the window; a gap that spans a prefill pass in
between counts whole."""
from stats import p95


def read(rec):
    return p95(rec.get("window", {}).get("itl_ms", []))
