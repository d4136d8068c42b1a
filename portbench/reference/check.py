"""The comparison that decides ``correct`` for a served model.

The program's served tokens are judged against the reference's logits at
the same positions, computed over the prompt and the served tokens
(teacher forcing): a served token's gap is how far its reference logit
lies below the reference's best at that position (0 where the program
chose the reference's own best). With random weights the top logits
crowd together, so a token is never compared for equality, only by this
gap. The control (``reference.model`` under ``quant="fp8"``) is read the
same way, for the token it puts first at each position.
"""
from __future__ import annotations

import torch


def gaps(ref, tokens):
    """ref: (n, ncb, V) logits; tokens: (n, ncb) ids. Each token's gap."""
    best = ref.max(dim=-1).values
    got = torch.gather(ref, -1, tokens.long()[..., None])[..., 0]
    return best - got


def widest_gap(refs, tokens) -> float:
    """The widest gap over every position and codebook of every
    sequence."""
    return max(float(gaps(r, t.to(r.device)).max()) for r, t in
               zip(refs, tokens))


def control_gap(refs, controls) -> float:
    """The widest gap of the tokens the control puts first."""
    return widest_gap(refs, [c.argmax(dim=-1) for c in controls])


NEAR_TIE = 0.02


def diagnose(refs, tokens, margins=None, prefix="") -> dict:
    """Numbers beside the widest gap: the mean gap over every served
    token, the worst request's mean gap (a fault confined to one slot's
    request moves it), the widest gap at each request's first token (its
    prefill), and for an MoE model the share of positions whose router
    margin is under ``NEAR_TIE`` in some layer and the widest gap
    elsewhere."""
    g = [gaps(r, t.to(r.device)).amax(dim=-1) for r, t in zip(refs, tokens)]
    flat = torch.cat(g)
    out = {f"{prefix}mean_gap": float(flat.mean()),
           f"{prefix}worst_req_gap": max(float(x.mean()) for x in g),
           f"{prefix}first_gap": max(float(x[0]) for x in g)}
    if margins:
        tie = torch.cat(margins) < NEAR_TIE
        out[f"{prefix}near_tie_share"] = float(tie.float().mean())
        out[f"{prefix}clear_gap"] = float(flat[~tie].max()) if (~tie).any() \
            else 0.0
    return out
