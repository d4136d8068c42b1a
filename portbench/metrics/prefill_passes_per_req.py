"""Prefill forward passes (``Engine.prefills``) per request admitted in
the window: 1 where every request is prefilled alone, below 1 where
``admit_many`` groups requests of one length into one pass."""


def read(rec):
    w = rec.get("window", {})
    if not w.get("admitted"):
        return None
    return w["prefills"] / w["admitted"]
