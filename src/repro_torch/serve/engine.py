"""Continuous-batching inference engine (the MTC-TRE payload), on the card.

The port of ``repro.serve.engine``, with the same ``admit_many`` contract:
slots of capacity ``max_len``; requests admitted together are grouped by
(prompt length, has-patches) and prefilled in one forward pass per group
(in fixed-size padded chunks with ``prefill_chunk``), then spliced into
their slots; a request whose prompt + patches + ``max_new_tokens`` exceeds
``max_len`` is rejected on its own; every active slot decodes together each
step; same-step finishes come back in admission order. A request finishes
when its budget runs out, never on a token value. Greedy sampling.

With ``page_size`` the attention KV lives in one shared page pool: pages
are allocated on admit and freed on finish, page 0 is the null page that
every inactive row's table points at, and decode reads K/V through the
table inside the paged kernel. Mamba2 caches (conv tails and SSM state)
have no sequence axis and stay slot-indexed in both modes; an arch with
no attention layer still allocates and frees its pages, as the JAX
engine does.

Caches are tensors updated in place (prefill splices are ``copy_`` into
slots or pages; decode writes the new token with ``index_put_``) where the
JAX engine donates buffers to jit. Slot bookkeeping stays in NumPy on the
host. A finished slot's length goes back to 0, so the decode step's write
for an inactive row stays inside its (null) cache row: torch raises on an
out-of-range index where JAX's scatter drops the write.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models.blocks import DECODE_BLOCK_S
from repro_torch.models.lm import LM, resolve_device
from repro_torch.serve.paged import PagedKVAllocator


@dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (P,) or (P,ncb) prompt tokens
    max_new_tokens: int = 16
    patches: np.ndarray | None = None
    out_tokens: list = field(default_factory=list)
    done: bool = False
    rejected: bool = False        # oversize for the cache: never admitted


class Engine:
    """``prefill_chunk``: run every grouped prefill at this fixed batch
    size, padding the final partial chunk by repeating its last row (the
    padded outputs are discarded). ``None`` prefills each group at its
    exact size. ``decode_block_s``: the cache positions each split of the
    contiguous decode kernel sweeps (a paged engine splits by page); with
    it equal to another engine's ``page_size`` the two decode bit for bit
    alike. ``device`` must be the LM's; ``None`` means the card."""

    def __init__(self, lm: LM, *, max_batch: int, max_len: int,
                 prefill_chunk: int | None = None,
                 page_size: int | None = None,
                 decode_block_s: int = DECODE_BLOCK_S, device=None):
        self.device = resolve_device(device)
        if lm.device != self.device:
            raise ValueError(f"LM lives on {lm.device}, engine on "
                             f"{self.device}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.prefill_chunk = prefill_chunk
        self.lm = lm
        self.max_batch, self.max_len = max_batch, max_len
        self.page_size = page_size
        self.decode_block_s = decode_block_s
        self.lengths = np.zeros((max_batch,), np.int32)
        self.active: dict[int, Request] = {}     # slot -> request
        self.free = list(range(max_batch))
        if page_size is None:
            self.pager = None
            self.caches = lm.init_cache(max_batch, max_len)
        else:
            if page_size < 1 or max_len % page_size:
                raise ValueError(
                    f"max_len ({max_len}) must be a positive multiple of "
                    f"page_size ({page_size})")
            self.pages_per_slot = max_len // page_size
            n_pages = 1 + max_batch * self.pages_per_slot
            self.pager = PagedKVAllocator(n_pages, page_size=page_size,
                                          reserve_null=True)
            self.caches = lm.init_paged_cache(max_batch, n_pages, page_size)
            self._page_table = np.zeros((max_batch, self.pages_per_slot),
                                        np.int32)
        self.steps = 0
        self.prefills = 0             # prefill forward passes run
        ncb = lm.cfg.n_codebooks
        tok_shape = (max_batch,) if ncb <= 1 else (max_batch, ncb)
        self._active_mask = np.zeros((max_batch,), bool)
        self._last_tok = np.zeros(tok_shape, np.int32)
        # generated tokens per slot (admit writes index 0; step appends);
        # +1 covers the prefill token of a budget-1 request
        self._out_buf = np.zeros((max_batch, max_len + 1) + tok_shape[1:],
                                 np.int32)
        self._out_len = np.zeros((max_batch,), np.int64)
        self._budget = np.zeros((max_batch,), np.int64)
        self._admit_seq = np.zeros((max_batch,), np.int64)
        self._seq = 0

    @property
    def active_count(self) -> int:
        return len(self.active)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ---------------------------------------------------------- prefill
    def admit(self, req: Request) -> bool:
        return bool(self.admit_many([req]))

    def admit_many(self, reqs: list[Request]) -> list[Request]:
        """Admit requests into free slots (as many as fit, in order) and
        return the admitted ones; the caller keeps the remainder.

        An oversize request (prompt + patches + ``max_new_tokens`` >
        ``max_len``) is marked ``rejected = done = True``, takes no slot
        and no page, and does not stop later requests from admitting.
        """
        groups: dict[tuple[int, bool], list[tuple[int, Request]]] = {}
        admitted: list[Request] = []
        order: dict[int, int] = {}          # slot -> call-order seq
        for req in reqs:
            if not self.free:
                break
            plen = len(req.tokens)
            n_img = self.lm.cfg.n_patches if req.patches is not None else 0
            if plen + n_img + req.max_new_tokens > self.max_len:
                req.rejected = True
                req.done = True
                continue
            slot = self.free.pop()
            if self.pager is not None:
                need = -(-(plen + n_img + req.max_new_tokens)
                         // self.page_size)
                pages = self.pager.alloc(slot, need)
                self._page_table[slot] = 0
                self._page_table[slot, :len(pages)] = pages
            order[slot] = self._seq
            self._seq += 1
            groups.setdefault((plen, req.patches is not None),
                              []).append((slot, req))
            admitted.append(req)
        step = self.prefill_chunk
        for (plen, has_patches), members in groups.items():
            for i0 in range(0, len(members), step or len(members)):
                part = members[i0:i0 + step] if step else members
                self._prefill_group(plen, has_patches, part, order,
                                    pad_to=step)
        return admitted

    def _prefill_group(self, plen: int, has_patches: bool, members,
                       order: dict[int, int],
                       pad_to: int | None = None) -> None:
        """One prefill forward pass for same-shape requests; splice each
        row's cache into its slot."""
        k = len(members)
        rows = [np.asarray(r.tokens) for _, r in members]
        if pad_to and k < pad_to:
            rows.extend([rows[-1]] * (pad_to - k))
        batch = {"tokens": self._to_device(np.stack(rows))}
        if has_patches:
            prows = [np.asarray(r.patches) for _, r in members]
            if pad_to and k < pad_to:
                prows.extend([prows[-1]] * (pad_to - k))
            batch["patches"] = self._to_device(np.stack(prows))
        n_img = self.lm.cfg.n_patches if has_patches else 0
        logits, pre_caches = self.lm.prefill(batch)
        self.prefills += 1
        toks = torch.argmax(logits, dim=-1)[:k].cpu().numpy().astype(np.int32)
        slots = np.array([s for s, _ in members])
        for i, (slot, req) in enumerate(members):
            self.lm.splice(self.caches, pre_caches, slot, i,
                           pages=None if self.pager is None
                           else self._page_table[slot],
                           page_size=self.page_size)
            self.active[slot] = req
            req.out_tokens.append(toks[i])
        self.lengths[slots] = plen + n_img
        self._last_tok[slots] = toks
        self._out_buf[slots, 0] = toks
        self._out_len[slots] = 1
        self._budget[slots] = [r.max_new_tokens for _, r in members]
        self._active_mask[slots] = True
        # call-order seqs (NOT group order): same-step finishes must come
        # back in admission order across shape groups
        self._admit_seq[slots] = [order[s] for s, _ in members]

    # ----------------------------------------------------------- decode
    def step(self) -> list[Request]:
        """One decode step for all active slots; returns finished requests."""
        if not self.active:
            return []
        ncb = self.lm.cfg.n_codebooks
        toks = (self._last_tok[:, None] if ncb <= 1
                else self._last_tok[:, None, :])
        table = (None if self.pager is None
                 else self._to_device(self._page_table))
        # a zero-budget request admitted at max_len decodes once from a full
        # row; only then does the step need the masked cache write
        full = self.lengths >= self.max_len
        logits, self.caches = self.lm.decode(
            self._to_device(toks), self._to_device(self.lengths),
            self.caches, page_table=table,
            full=self._to_device(full) if full.any() else None,
            block_s=self.decode_block_s)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int32)
        mask = self._active_mask
        self._last_tok[mask] = nxt[mask]
        self._out_buf[mask, self._out_len[mask]] = nxt[mask]
        self._out_len[mask] += 1
        self.lengths += mask.astype(np.int32)
        self.steps += 1
        done = np.nonzero(mask & (self._out_len >= self._budget))[0]
        # finish in admission order: the env observes completions in the
        # same order a per-slot event queue would deliver them
        done = done[np.argsort(self._admit_seq[done], kind="stable")]
        finished = []
        for slot in (int(s) for s in done):
            req = self.active.pop(slot)
            req.done = True
            req.out_tokens = [self._out_buf[slot, i]
                              for i in range(int(self._out_len[slot]))]
            self._active_mask[slot] = False
            self.lengths[slot] = 0
            if self.pager is not None:
                self.pager.free(slot)
                self._page_table[slot] = 0   # back to the null page
            self.free.append(slot)
            finished.append(req)
        return finished

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve a list of requests to completion (admitting as slots
        free). Oversize requests come back in the result marked
        ``rejected`` with no output tokens."""
        pending = list(requests)
        done: list[Request] = []
        while pending or self.active:
            if pending and self.free:
                window = pending[:len(self.free)]
                taken = {id(r) for r in self.admit_many(window)}
                for req in window:
                    if req.rejected:
                        done.append(req)
                        taken.add(id(req))
                pending = [r for r in pending if id(r) not in taken]
            done.extend(self.step())
        return done
