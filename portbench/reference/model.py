"""The plain fp32 reference of the served models.

A decoder of attention blocks over a nested weight dict (the layout
``portbench.weights`` draws), written from the model equations alone:
RMSNorm, split-halves RoPE, causal GQA attention, a SwiGLU MLP, and for
an MoE block an fp32 softmax router over every expert, the top-k gates
renormalised, each token's experts added whole (no capacity, no drop)
beside a dense residual MLP on the same normed input. Multi-codebook
models sum one embedding per codebook and read one head per codebook.

It imports only torch and the standard library and reads nothing the
program made: the weights are the benchmark's own draws, upcast here a
layer (and, for experts, an expert) at a time, so a 27.7 B parameter cut
runs in fp32 on one card. TF32 is switched off while it runs.

``quant="fp8"`` is the precision control: every linear layer's weight is
rounded to float8 e4m3 with a scale per output column, and its input to
e4m3 with a scale per row, then multiplied in fp32; norms, RoPE,
softmaxes and the router stay fp32.

``quant="bf16"`` is a witness, not a control: every linear layer's
weight and input, and the router's, rounded to bfloat16 (the served
precision) and multiplied in fp32. It reads what rounding to the served
precision alone does to the served tokens' gaps, with no code of the
program in it.
"""
from __future__ import annotations

import contextlib
import math

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """fp32 products without TF32, restored after."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


def fp8_round(t, dim: int):
    """``t`` rounded to e4m3 with one scale per slice along ``dim`` (the
    amax over ``dim`` maps to the format's largest value), back in fp32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def bf16_round(t):
    return t.to(torch.bfloat16).float()


class Linear:
    """x @ w in fp32, or with both rounded to e4m3 or bf16 under
    ``quant``."""

    def __init__(self, quant: str | None):
        if quant not in (None, "fp8", "bf16"):
            raise ValueError(f"quant {quant!r}: None, 'fp8' or 'bf16'")
        self.quant = quant

    def weight(self, w):
        w = w.float()
        if self.quant == "fp8":
            return fp8_round(w, -2)
        return bf16_round(w) if self.quant == "bf16" else w

    def __call__(self, x, w):
        """``w`` already through ``weight``."""
        if self.quant == "fp8":
            x = fp8_round(x, -1)
        elif self.quant == "bf16":
            x = bf16_round(x)
        return x @ w

    def router(self, x, w):
        """The router's logits: fp32, or from bf16-rounded operands under
        ``quant="bf16"``."""
        if self.quant == "bf16":
            return bf16_round(x) @ bf16_round(w)
        return x @ w.float()


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x: (S, H, hd), positions 0..S-1, split halves."""
    S, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x, w, m, lin):
    """Causal attention of one sequence x (S, d), fp32."""
    S = x.shape[0]
    H, KVH, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = rope(lin(x, w["wq"]).reshape(S, H, hd), m["rope_theta"])
    k = rope(lin(x, w["wk"]).reshape(S, KVH, hd), m["rope_theta"])
    v = lin(x, w["wv"]).reshape(S, KVH, hd)
    k = k.repeat_interleave(H // KVH, dim=1)
    v = v.repeat_interleave(H // KVH, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", p, v).reshape(S, H * hd)
    return lin(o, w["wo"])


def mlp(x, w, lin):
    g = lin(x, w["w_gate"])
    return lin(torch.nn.functional.silu(g) * lin(x, w["w_in"]), w["w_out"])


def moe(x, w, layer: int, m, lin, margins=None):
    """Every token's top-k experts, gates renormalised, added whole.
    ``margins``: a list that gets each token's router margin, the logit
    of its k-th expert less that of the next."""
    scores = lin.router(x, w["router"][layer])
    probs = torch.softmax(scores, dim=-1)
    wts, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = m["top_k"]
    if margins is not None:
        top = torch.topk(scores, k + 1, dim=-1).values
        margins.append(top[:, k - 1] - top[:, k])
    wts, ids = wts[:, :k], ids[:, :k]
    wts = wts / wts.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros_like(x)
    for e in torch.unique(ids).tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        we = {n: lin.weight(w[n][layer, e])
              for n in ("w_in", "w_gate", "w_out")}
        y.index_add_(0, tok, mlp(x[tok], we, lin) * wts[tok, slot, None])
    return y


def layer_weights(blocks, layer: int, lin, skip=("moe",)):
    """Layer ``layer``'s dense weights, fp32 (or fp8-rounded)."""
    def up(tree):
        return {k: up(v) if isinstance(v, dict) else
                (lin.weight(v[layer]) if v.dim() > 2 else v[layer].float())
                for k, v in tree.items() if k not in skip}
    return up(blocks)


@torch.no_grad()
def logits(m: dict, params, seqs, score, quant: str | None = None,
           margins=None):
    """Logits of each sequence at its scored positions.

    ``seqs``: token tensors (S,) or (S, ncb) on the weights' device;
    ``score``: per sequence, the positions whose next-token logits are
    wanted. Returns one (n, ncb, vocab_padded) fp32 tensor a sequence.
    Runs layer by layer over all the sequences, so each layer's weights
    are upcast once. ``margins``, for an MoE model: a list that gets, per
    sequence, each scored position's smallest router margin over the
    layers (``moe``)."""
    lin = Linear(quant)
    eps = m["norm_eps"]
    emb = params["embed"]
    with exact_fp32():
        xs = []
        for toks in seqs:
            toks = toks if toks.dim() == 2 else toks[:, None]
            xs.append(sum(emb[c][toks[:, c]].float()
                          for c in range(toks.shape[1])))
        blocks = params["blocks"]["pos0"]
        per_layer = [] if margins is not None else None
        for layer in range(m["n_layers"]):
            w = layer_weights(blocks, layer, lin)
            xs = [x + attention(rmsnorm(x, w["norm1"], eps), w["attn"], m,
                                lin) for x in xs]
            hs = [rmsnorm(x, w["norm2"], eps) for x in xs]
            h = torch.cat(hs)
            if "moe" in blocks:
                y = moe(h, blocks["moe"], layer, m, lin, per_layer)
                if "dense_mlp" in w:
                    y = y + mlp(h, w["dense_mlp"], lin)
            else:
                y = mlp(h, w["mlp"], lin)
            xs = list(torch.split(torch.cat(xs) + y,
                                  [x.shape[0] for x in xs]))
            del w, hs, h, y
        if per_layer:
            low = torch.stack(per_layer).min(dim=0).values
            margins.extend(part[at] for part, at in zip(
                torch.split(low, [x.shape[0] for x in xs]), score))
        out = []
        final = params["final_norm"].float()
        head = params["head"]
        for x, at in zip(xs, score):
            x = rmsnorm(x[at], final, eps)
            out.append(torch.stack([lin(x, lin.weight(head[c]))
                                    for c in range(head.shape[0])], dim=1))
        return out
