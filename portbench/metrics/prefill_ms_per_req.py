"""Host-clock milliseconds inside ``Engine.admit_many`` (which ends on
the host with the first tokens) per request admitted in the window."""


def read(rec):
    w = rec.get("window", {})
    if not w.get("admitted"):
        return None
    return sum(ms for ms, _ in w["admit_ms"]) / w["admitted"]
