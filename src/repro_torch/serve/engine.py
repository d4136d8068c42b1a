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

With a runtime whose mesh spans several ranks (``rt``, as the JAX engine
takes one), every rank runs this engine on the same requests: the host
bookkeeping (lengths, slots, finish order, the length reset) is the same
on every rank, the forward passes run their collectives
(``models.blocks``), and every rank returns the same finished requests.
The LM's weights must be the rank's slices for that runtime
(``bridge.init_params`` or ``params_from_jax`` with its mesh and
``ParallelConfig``). Where attention splits by heads, each rank's caches
and pages hold its KV heads, and its Mamba2 caches its SSM heads. Under
``decode_kv_shard`` "seq" each rank's contiguous cache holds its
``max_len / n`` positions and a prefill splice writes each rank's slice;
paged KV then raises, as in the reference.

The slots split over the mesh's batch axes (``pod``, ``data``) as the
reference's cache specs split the decode batch (``Runtime.rows``): when
``max_batch`` divides over them, slot s lives on batch rank s // (max_batch
/ n), whose caches (and page pool) hold its ``max_batch / n`` slots, and
each rank decodes its slots and all-gathers their greedy ids. Otherwise
every rank holds every slot. A prefill group of k rows (``prefill_chunk``
rows when set) splits the same way when k divides: each rank prefills its
rows, the ids all-gather, and a row whose slot another rank holds moves
there point to point (``parallel.collectives.exchange``; ``moved_rows``
counts them), so no rank holds more than its own rows' prefill caches and
the rows it receives. A group that does not divide runs whole on every
rank, which splices the rows of its own slots. The slot choice, lengths,
budgets and finish order stay the same on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import meta_params
from repro_torch.models.blocks import DECODE_BLOCK_S
from repro_torch.models.lm import (
    LM, Runtime, resolve_device, tree_leaves, tree_map)
from repro_torch.parallel.collectives import exchange, gather_rows
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
    alike. ``device`` must be the LM's; ``None`` means the card. ``rt``:
    the runtime (``models.lm.Runtime``), None for one rank; its mesh must
    live on the LM's device."""

    def __init__(self, lm: LM, *, rt: Runtime | None = None, max_batch: int,
                 max_len: int, prefill_chunk: int | None = None,
                 page_size: int | None = None,
                 decode_block_s: int = DECODE_BLOCK_S, device=None):
        self.device = resolve_device(device)
        if lm.device != self.device:
            raise ValueError(f"LM lives on {lm.device}, engine on "
                             f"{self.device}")
        self.rt = rt or Runtime()
        if self.rt.mesh is not None and self.rt.mesh.device != self.device:
            raise ValueError(f"mesh lives on {self.rt.mesh.device}, engine "
                             f"on {self.device}")
        want = dict(tree_leaves(meta_params(
            lm.cfg, mesh=self.rt.mesh, parallel=self.rt.parallel)))
        for path, t in tree_leaves(lm.params):
            if tuple(t.shape) != tuple(want[path].shape):
                raise ValueError(
                    f"param {path} holds {tuple(t.shape)}, the runtime's "
                    f"split {tuple(want[path].shape)}: build the weights "
                    "with the runtime's mesh and ParallelConfig")
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
        if page_size is not None and self.rt.decode_kv_shard(lm.cfg) == "seq":
            raise ValueError(
                "paged KV is incompatible with decode_kv_shard='seq'")
        # this rank's positions of each slot's cache under "seq"
        self.window = self.rt.seq_window(lm.cfg, max_len)
        # the slots this rank holds, [own.start, own.stop), and the group
        # over the batch axes that holds the others (None: every rank
        # holds every slot)
        self.rows = self.rt.rows(max_batch)
        self.own, self.data = self.rows or (slice(0, max_batch), None)
        held = self.own.stop - self.own.start
        self.moved_rows = 0           # prefill rows sent to another rank
        if page_size is None:
            self.pager = None
            self.caches = lm.init_cache(
                held, max_len if self.window is None
                else self.window[1] - self.window[0], self.rt)
        else:
            if page_size < 1 or max_len % page_size:
                raise ValueError(
                    f"max_len ({max_len}) must be a positive multiple of "
                    f"page_size ({page_size})")
            self.pages_per_slot = max_len // page_size
            n_pages = 1 + held * self.pages_per_slot
            self.pager = PagedKVAllocator(n_pages, page_size=page_size,
                                          reserve_null=True)
            self.caches = lm.init_paged_cache(held, n_pages, page_size,
                                              self.rt)
            # rows of the slots this rank holds
            self._page_table = np.zeros((held, self.pages_per_slot),
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

    def holds(self, slot: int) -> bool:
        """Whether this rank holds ``slot``'s caches and pages."""
        return self.own.start <= slot < self.own.stop

    def _local(self, slot: int) -> int:
        """``slot``'s row in this rank's caches and page table."""
        return slot - self.own.start

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
            if self.pager is not None and self.holds(slot):
                need = -(-(plen + n_img + req.max_new_tokens)
                         // self.page_size)
                pages = self.pager.alloc(slot, need)
                row = self._local(slot)
                self._page_table[row] = 0
                self._page_table[row, :len(pages)] = pages
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
        row's cache into its slot, on the ranks that hold it."""
        k = len(members)
        rows = [np.asarray(r.tokens) for _, r in members]
        if pad_to and k < pad_to:
            rows.extend([rows[-1]] * (pad_to - k))
        split = self.rt.rows(len(rows))
        mine, data = split or (slice(None), None)
        batch = {"tokens": self._to_device(np.stack(rows)[mine])}
        if has_patches:
            prows = [np.asarray(r.patches) for _, r in members]
            if pad_to and k < pad_to:
                prows.extend([prows[-1]] * (pad_to - k))
            batch["patches"] = self._to_device(np.stack(prows)[mine])
        n_img = self.lm.cfg.n_patches if has_patches else 0
        logits, pre_caches = self.lm.prefill(batch, rt=self.rt, rows=split)
        self.prefills += 1
        toks = gather_rows(torch.argmax(logits, dim=-1), data)
        toks = toks[:k].cpu().numpy().astype(np.int32)
        sends, recvs = [], []       # (rank, a row's caches[, slot])
        if split is None:
            # every rank ran every row: each splices the slots it holds
            for i, (slot, _) in enumerate(members):
                if self.holds(slot):
                    self._splice(pre_caches, slot, i)
        else:
            # row i ran on batch rank i // per; its slot lives on one rank,
            # or on every rank when the slots are not split
            me, n = dist.get_rank(data), dist.get_world_size(data)
            per, held = mine.stop - mine.start, self.own.stop - self.own.start
            for i, (slot, _) in enumerate(members):
                src = i // per
                for dst in (range(n) if self.data is None
                            else (slot // held,)):
                    if src == dst == me:
                        self._splice(pre_caches, slot, i - mine.start)
                    elif src != dst:
                        self.moved_rows += 1
                        if src == me:
                            sends.append((dst, _row(pre_caches,
                                                    i - mine.start)))
                        elif dst == me:
                            recvs.append((src, _row(pre_caches, 0), slot))
        for i, (slot, req) in enumerate(members):
            self.active[slot] = req
            req.out_tokens.append(toks[i])
        if split is not None:
            got = iter(exchange(
                [(dst, t) for dst, row in sends for t in _leaves(row)],
                [(src, t) for src, row, _ in recvs for t in _leaves(row)],
                data))
            for _, like, slot in recvs:
                self._splice(_filled(like, got), slot, 0)
        slots = np.array([s for s, _ in members])
        self.lengths[slots] = plen + n_img
        self._last_tok[slots] = toks
        self._out_buf[slots, 0] = toks
        self._out_len[slots] = 1
        self._budget[slots] = [r.max_new_tokens for _, r in members]
        self._active_mask[slots] = True
        # call-order seqs (NOT group order): same-step finishes must come
        # back in admission order across shape groups
        self._admit_seq[slots] = [order[s] for s, _ in members]

    def _splice(self, pre, slot: int, row: int) -> None:
        """Row ``row`` of prefill caches ``pre`` into this rank's row of
        ``slot``."""
        local = self._local(slot)
        self.lm.splice(self.caches, pre, local, row,
                       pages=None if self.pager is None
                       else self._page_table[local],
                       page_size=self.page_size, window=self.window)

    # ----------------------------------------------------------- decode
    def step(self) -> list[Request]:
        """One decode step for all active slots; returns finished requests."""
        if not self.active:
            return []
        own = self.own
        toks = self._last_tok[own][:, None]
        table = (None if self.pager is None
                 else self._to_device(self._page_table))
        # a zero-budget request admitted at max_len decodes once from a full
        # row; only then does the step need the masked cache write
        full = self.lengths[own] >= self.max_len
        logits, self.caches = self.lm.decode(
            self._to_device(toks), self._to_device(self.lengths[own]),
            self.caches, page_table=table, rt=self.rt,
            full=self._to_device(full) if full.any() else None,
            rows=self.rows, block_s=self.decode_block_s)
        nxt = gather_rows(torch.argmax(logits, dim=-1), self.data)
        nxt = nxt.cpu().numpy().astype(np.int32)
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
            if self.pager is not None and self.holds(slot):
                self.pager.free(slot)
                self._page_table[self._local(slot)] = 0   # the null page
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


def _row(caches, row: int):
    """Row ``row`` of a cache tree, batch axis kept (one row)."""
    return tree_map(lambda t: t[:, row:row + 1], caches)


def _leaves(tree) -> list:
    """A cache tree's tensors in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def _filled(like, leaves):
    """The tree of ``like`` holding the next tensors of the iterator
    ``leaves``, in ``_leaves``' order."""
    return tree_map(lambda _: next(leaves), like)
