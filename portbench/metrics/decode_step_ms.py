"""Mean host-clock milliseconds of ``Engine.step`` (which ends on the
host with the greedy ids) over the window's steps."""


def read(rec):
    steps = rec.get("window", {}).get("step_ms")
    return sum(steps) / len(steps) if steps else None
