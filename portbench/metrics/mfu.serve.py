"""The whole step's share of the card's bf16 peak in the window: model
FLOPs (``flops.model_flops``: 2 x the active parameters a token) of the
prompt tokens admitted and the output tokens emitted in the window, no
padding and no recompute, over the window's seconds x the peak, in %."""
import cost
import flops


def read(rec):
    w = rec.get("window")
    if not w or not w.get("seconds"):
        return None
    n = w["prompt_tokens"] + w["tokens"]
    return 100.0 * flops.serve_flops(rec["model"], n) / (
        w["seconds"] * cost.PEAK_FLOPS["bf16"])
