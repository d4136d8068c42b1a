"""Decoder LM assembly: embeddings -> layer loop -> head(s)
(``repro.models.lm``, serving half).

Params are the JAX package's nested dict, leaf for leaf: ``embed``
(ncb, Vp, d), ``head`` (ncb, d, Vp), ``final_norm`` (d,) and
``blocks/pos{i}/...`` with the stacked leading ``R = n_layers / period``
axis. Caches keep the JAX layouts, by the kind of layer at pattern
position i: attention ``(k, v)`` with k, v of (R, B, S, KVH, hd), or
(R, n_pages, page_size, KVH, hd) when paged; Mamba2 ``({"x", "B", "C"}
conv tails (R, B, k-1, ch) in the model's dtype, state (R, B, nh, hp, ds)
fp32)``, slot-indexed in both modes. Where JAX scans over R, this module
loops over per-layer views.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.blocks import DECODE_BLOCK_S, block_apply
from repro_torch.models.layers import rmsnorm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one, raise: the CPU runs only when
    the caller asks for it with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # "cuda" and "cuda:0" name one card; tensors report the index
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def tree_leaves(tree, prefix=""):
    """(path, tensor) pairs of a nested dict, depth first, '/'-joined."""
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from tree_leaves(val, path)
        else:
            yield path, val


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def _stack(trees):
    """Stack a list of same-structure cache trees leaf by leaf (axis 0)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([t[j] for t in trees]) for j in range(len(first)))
    return torch.stack(trees)


class LM(nn.Module):
    """Serving forward passes of one decoder over a nested param dict.

    ``params`` must already live on ``device`` (``bridge.init_params`` or
    ``bridge.params_from_jax`` put them there). They stay the plain nested
    dict of the JAX layout, so the bridge is a leaf-wise copy; the module
    is not moved with ``.to()``.
    """

    def __init__(self, cfg, params, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        for path, t in tree_leaves(params):
            if t.device != self.device:
                raise ValueError(f"param {path} lives on {t.device}, "
                                 f"not {self.device}")
        self.params = params
        self.period = cfg.pattern_period
        self.repeats = cfg.n_layers // self.period
        # per-layer views of the stacked (R, ...) leaves, in layer order
        self._layers = [
            [tree_map(lambda t, r=r: t[r], params["blocks"][f"pos{i}"])
             for i in range(self.period)]
            for r in range(self.repeats)]

    # ------------------------------------------------------------ embed
    def embed(self, batch):
        """batch: tokens (B, S[, ncb]) int; optional patches (B, Np, d)."""
        cfg = self.cfg
        emb = self.params["embed"]                     # (ncb, Vp, d)
        tokens = batch["tokens"].to(self.device).long()
        if cfg.n_codebooks > 1:
            x = torch.zeros(tokens.shape[:2] + (cfg.d_model,),
                            dtype=emb.dtype, device=self.device)
            for c in range(cfg.n_codebooks):
                x = x + emb[c][tokens[..., c]]
        else:
            x = emb[0][tokens]
        if cfg.vision_stub and "patches" in batch:
            patches = batch["patches"].to(self.device, x.dtype)
            x = torch.cat([patches, x], dim=1)
        return x

    def logits(self, x):
        """Over ``vocab_padded``: greedy argmax sees the padded columns too,
        as in the JAX engine."""
        if self.cfg.n_codebooks > 1:
            return torch.einsum("bsd,cdv->bscv", x, self.params["head"])
        return x @ self.params["head"][0]

    # ------------------------------------------------------------- serve
    @torch.no_grad()
    def prefill(self, batch):
        """Full-sequence forward; returns (last_logits (B, [ncb,] Vp),
        caches {"pos{i}": ...} in the module's layouts with B rows and, for
        attention, S positions)."""
        x = self.embed(batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        per_pos = [[] for _ in range(self.period)]
        for layer in self._layers:
            for i, p in enumerate(layer):
                x, cache = block_apply(p, self.cfg, x, positions, i)
                per_pos[i].append(cache)
        x = rmsnorm(self.params["final_norm"], x, self.cfg.norm_eps)
        logits = self.logits(x[:, -1:])
        caches = {f"pos{i}": _stack(per_pos[i]) for i in range(self.period)}
        return logits[:, 0], caches

    @torch.no_grad()
    def decode(self, tokens, lengths, caches, page_table=None, *,
               full=None, block_s: int = DECODE_BLOCK_S):
        """tokens: (B, 1[, ncb]); lengths: (B,) int32 current cache fill on
        the device; page_table: (B, pages_per_row) int32 for paged caches.
        ``full``: None when no row's length equals its capacity, else a
        (B,) bool tensor on the device marking those rows, which then
        write nothing (``attn_block``). ``block_s``: the contiguous decode
        kernel's split.

        Writes each row's new K/V, conv tails and SSM state into ``caches``
        in place and returns (logits (B, [ncb,] Vp), caches).
        """
        x = self.embed({"tokens": tokens})
        positions = lengths.long()[:, None]
        for r, layer in enumerate(self._layers):
            for i, p in enumerate(layer):
                cache = tree_map(lambda t, r=r: t[r], caches[f"pos{i}"])
                x, _ = block_apply(p, self.cfg, x, positions, i, cache=cache,
                                   lengths=lengths, page_table=page_table,
                                   full=full, block_s=block_s)
        x = rmsnorm(self.params["final_norm"], x, self.cfg.norm_eps)
        return self.logits(x)[:, 0], caches

    # ------------------------------------------------------------ caches
    def cache_kind(self, key: str) -> str:
        """"attn" or "ssm": the kind of layer whose cache ``key`` ("pos{i}")
        holds."""
        return self.cfg.block_kind(int(key.removeprefix("pos")))

    def splice(self, caches, pre, slot: int, row: int, *, pages=None,
               page_size: int | None = None) -> None:
        """Copy row ``row`` of prefill caches ``pre`` into ``slot`` of
        ``caches``, in place: attention K/V (P positions) into the slot's
        first P rows, or with ``pages`` (the slot's page ids, in order)
        into its pages; Mamba2 conv tails and state into ``[:, slot]`` in
        both modes."""
        for key, cache in caches.items():
            if self.cache_kind(key) != "attn":
                conv, state = cache
                src_conv, src_state = pre[key]
                for name, dst in conv.items():
                    dst[:, slot].copy_(src_conv[name][:, row])
                state[:, slot].copy_(src_state[:, row])
                continue
            for dst, src in zip(cache, pre[key]):
                src = src[:, row]                     # (R, P, KVH, hd)
                P = src.shape[1]
                if pages is None:
                    dst[:, slot, :P].copy_(src)
                    continue
                ps = page_size
                for j0 in range(0, P, ps):
                    cs = min(ps, P - j0)
                    dst[:, int(pages[j0 // ps]), :cs].copy_(src[:, j0:j0 + cs])

    # ------------------------------------------------- cache construction
    def _ssm_cache(self, batch_size: int):
        """A Mamba2 position's cache as meta tensors (shape and dtype)."""
        cfg, R = self.cfg, self.repeats
        k1, ch_bc = cfg.conv_dim - 1, cfg.ssm_groups * cfg.d_state
        conv = {"x": (R, batch_size, k1, cfg.d_inner),
                "B": (R, batch_size, k1, ch_bc),
                "C": (R, batch_size, k1, ch_bc)}
        state = (R, batch_size, cfg.n_ssm_heads, cfg.ssm_head_dim,
                 cfg.d_state)
        return ({k: torch.empty(s, dtype=self.dtype, device="meta")
                 for k, s in conv.items()},
                torch.empty(state, dtype=torch.float32, device="meta"))

    def _shapes(self, batch_size: int, kv_shape):
        kv = torch.empty(kv_shape, dtype=self.dtype, device="meta")
        return {f"pos{i}": (kv, kv) if self.cfg.block_kind(i) == "attn"
                else self._ssm_cache(batch_size)
                for i in range(self.period)}

    def cache_shapes(self, batch_size: int, max_len: int):
        """{"pos{i}": cache} as meta tensors: attention (k, v) each (R, B,
        S, KVH, hd); Mamba2 (conv tails, fp32 state)."""
        cfg = self.cfg
        return self._shapes(batch_size, (self.repeats, batch_size, max_len,
                                         cfg.n_kv_heads, cfg.head_dim))

    def paged_cache_shapes(self, batch_size: int, n_pages: int,
                           page_size: int):
        """Attention KV in a shared page pool, each (R, n_pages, page_size,
        KVH, hd), addressed through a per-row page table; Mamba2 caches
        hold no sequence axis and stay slot-indexed."""
        cfg = self.cfg
        return self._shapes(batch_size, (self.repeats, n_pages, page_size,
                                         cfg.n_kv_heads, cfg.head_dim))

    def _zeros(self, shapes):
        return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                              device=self.device), shapes)

    def init_cache(self, batch_size: int, max_len: int):
        return self._zeros(self.cache_shapes(batch_size, max_len))

    def init_paged_cache(self, batch_size: int, n_pages: int,
                         page_size: int):
        return self._zeros(self.paged_cache_shapes(batch_size, n_pages,
                                                   page_size))
