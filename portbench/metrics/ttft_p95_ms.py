"""p95 over every request admitted in the window of the time from its
hand-off to ``Engine.admit_many`` to the return of that call, which
holds its first token on the host."""
from stats import p95


def read(rec):
    return p95(rec.get("window", {}).get("ttft_ms", []))
