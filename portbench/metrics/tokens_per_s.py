"""Output tokens emitted in the window (a prefill's first token and every
decode step's, finished requests or not) over the window's seconds. A
musicgen token is a frame: one per row and step, of 4 codebook ids."""


def read(rec):
    w = rec.get("window")
    if not w or "tokens" not in w:
        return None
    return w["tokens"] / w["seconds"]
