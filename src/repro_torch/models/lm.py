"""Decoder LM assembly: embeddings -> layer loop -> head(s)
(``repro.models.lm``, serving half).

Params are the JAX package's nested dict, leaf for leaf: ``embed``
(ncb, Vp, d), ``head`` (ncb, d, Vp), ``final_norm`` (d,) and
``blocks/pos{i}/...`` with the stacked leading ``R = n_layers / period``
axis. Caches keep the JAX layouts: ``{"pos{i}": (k, v)}`` with k, v of
(R, B, S, KVH, hd), or (R, n_pages, page_size, KVH, hd) when paged.
Where JAX scans over R, this module loops over per-layer views.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.blocks import block_apply, check_supported
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
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class LM(nn.Module):
    """Serving forward passes of one decoder over a nested param dict.

    ``params`` must already live on ``device`` (``bridge.init_params`` or
    ``bridge.params_from_jax`` put them there). They stay the plain nested
    dict of the JAX layout, so the bridge is a leaf-wise copy; the module
    is not moved with ``.to()``.
    """

    def __init__(self, cfg, params, *, device=None):
        super().__init__()
        check_supported(cfg)
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
        caches {"pos{i}": (k, v)} with k, v (R, B, S, KVH, hd))."""
        x = self.embed(batch)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        ks = [[] for _ in range(self.period)]
        vs = [[] for _ in range(self.period)]
        for layer in self._layers:
            for i, p in enumerate(layer):
                x, (k, v) = block_apply(p, self.cfg, x, positions)
                ks[i].append(k)
                vs[i].append(v)
        x = rmsnorm(self.params["final_norm"], x, self.cfg.norm_eps)
        logits = self.logits(x[:, -1:])
        caches = {f"pos{i}": (torch.stack(ks[i]), torch.stack(vs[i]))
                  for i in range(self.period)}
        return logits[:, 0], caches

    @torch.no_grad()
    def decode(self, tokens, lengths, caches, page_table=None):
        """tokens: (B, 1[, ncb]); lengths: (B,) int32 current cache fill on
        the device; page_table: (B, pages_per_row) int32 for paged caches.

        Writes each row's new K/V into ``caches`` in place and returns
        (logits (B, [ncb,] Vp), caches).
        """
        x = self.embed({"tokens": tokens})
        positions = lengths.long()[:, None]
        for r, layer in enumerate(self._layers):
            for i, p in enumerate(layer):
                k_all, v_all = caches[f"pos{i}"]
                x, _ = block_apply(p, self.cfg, x, positions,
                                   cache=(k_all[r], v_all[r]),
                                   lengths=lengths, page_table=page_table)
        x = rmsnorm(self.params["final_norm"], x, self.cfg.norm_eps)
        return self.logits(x)[:, 0], caches

    # ------------------------------------------------- cache construction
    def cache_shapes(self, batch_size: int, max_len: int):
        """{"pos{i}": (k_shape, v_shape)}, each (R, B, S, KVH, hd)."""
        cfg = self.cfg
        kv = (self.repeats, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {f"pos{i}": (kv, kv) for i in range(self.period)}

    def paged_cache_shapes(self, batch_size: int, n_pages: int,
                           page_size: int):
        """Attention KV in a shared page pool: each (R, n_pages, page_size,
        KVH, hd), addressed through a per-row page table. ``batch_size``
        is kept for the JAX signature: attention-only slices hold no
        slot-indexed state."""
        cfg = self.cfg
        kv = (self.repeats, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        return {f"pos{i}": (kv, kv) for i in range(self.period)}

    def _zeros(self, shapes):
        return {key: tuple(torch.zeros(s, dtype=self.dtype,
                                       device=self.device) for s in pair)
                for key, pair in shapes.items()}

    def init_cache(self, batch_size: int, max_len: int):
        return self._zeros(self.cache_shapes(batch_size, max_len))

    def init_paged_cache(self, batch_size: int, n_pages: int,
                         page_size: int):
        return self._zeros(self.paged_cache_shapes(batch_size, n_pages,
                                                   page_size))
