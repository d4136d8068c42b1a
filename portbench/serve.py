"""The serving cells: a paged ``repro_torch.serve.engine.Engine`` fed by
a closed backlog (``gen/serve_backlog.py``).

Set-up builds the kernels (first run in a checkout only), draws the
weights on the card, builds the engine, and warms it up on the cell's
own traffic: one prefill at the longest prompt the traffic holds, then
``warmup_steps`` of the loop, which fill the engine. The window then
runs the loop for ``--seconds``: before each step, ready tasks are
admitted first come first served into free slots within the
deployment's prefill budget (the configuration's
``serve.prefill_tokens_per_step``; one ``admit_many``), then one
``step``. Token times are the host clock at the return of the call that
produced them (both end on the host, with the greedy ids copied back).

With ``--trace 1`` the window runs untraced as before, and a traced
slice of ``TRACE_SECONDS`` more of the same loop follows it
(``profiling.py``): the spans around each call read the host clock in the
window, the device numbers come from the slice.

After the window the requests it finished are sampled from the seed,
the longest always among them, the program's state is freed, and the
plain reference (``reference/model.py``) scores the served tokens.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

import profiling as tr
import weights as wts
from reference import check, model as ref

TRACE_SECONDS = 2.0


def build_engine(cfg_file: dict, params, device):
    """The port's LM and paged engine for a configuration file."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import Engine
    cfg = dataclasses.replace(get_config(cfg_file["arch"]),
                              **cfg_file["model"])
    lm = LM(cfg, params, device=device)
    s = cfg_file["serve"]
    return Engine(lm, max_batch=s["max_batch"], max_len=s["max_len"],
                  page_size=s["page_size"], device=device)


class Loop:
    """The admission-then-step loop and its records."""

    def __init__(self, engine, backlog, budget: int):
        from repro_torch.serve.engine import Request
        self.Request = Request
        self.budget = budget
        self.eng, self.backlog = engine, backlog
        self.task = {}            # rid -> Task
        self.last = {}            # rid -> time of its last token
        self.reset()

    def reset(self):
        self.ttft, self.itl, self.admit_ms, self.step_ms = [], [], [], []
        self.tokens = self.admitted = self.prompt_tokens = 0
        self.rejected = 0
        self.finished = []
        self.prefills0 = self.eng.prefills

    def once(self, spans=False):
        """Admit into free slots, then one decode step. Returns the time
        at the end."""
        from torch.profiler import record_function
        eng = self.eng
        tasks = self.backlog.take(len(eng.free), self.budget)
        if tasks:
            reqs = [self.Request(t.rid, t.prompt, max_new_tokens=t.max_new)
                    for t in tasks]
            t0 = time.perf_counter()
            if spans:
                with record_function("pb.admit"):
                    got = eng.admit_many(reqs)
            else:
                got = eng.admit_many(reqs)
            t1 = time.perf_counter()
            self.admit_ms.append(((t1 - t0) * 1e3, len(got)))
            for t, r in zip(tasks, reqs):
                if r.rejected:
                    self.rejected += 1
                    self.backlog.done(t)
                    continue
                self.task[r.rid] = t
                self.ttft.append((t1 - t0) * 1e3)
                self.last[r.rid] = t1
                self.tokens += 1
                self.admitted += 1
                self.prompt_tokens += len(t.prompt)
        active = list(eng.active.values())
        t0 = time.perf_counter()
        if spans:
            with record_function("pb.step"):
                done = eng.step()
        else:
            done = eng.step()
        t1 = time.perf_counter()
        self.step_ms.append((t1 - t0) * 1e3)
        for r in active:
            self.itl.append((t1 - self.last[r.rid]) * 1e3)
            self.last[r.rid] = t1
        self.tokens += len(active)
        for r in done:
            # the tokens as delivered: for a multi-codebook model each is
            # a view of the engine's buffer, which the slot's next
            # request overwrites
            r.out_tokens = [np.array(t) for t in r.out_tokens]
            self.finished.append(r)
            self.last.pop(r.rid, None)
            self.backlog.done(self.task.pop(r.rid))
        return t1


def warm_up(loop, max_prompt: int, steps: int):
    """One prefill at the traffic's longest prompt (the largest prefill
    buffers the window can ask for), ``steps`` of the loop, then more
    until no slot is free, so the window opens on a full engine."""
    eng = loop.eng
    ncb = eng.lm.cfg.n_codebooks
    shape = (1, max_prompt) if ncb <= 1 else (1, max_prompt, ncb)
    eng.lm.prefill({"tokens": torch.zeros(shape, dtype=torch.int32,
                                          device=eng.lm.device)})
    for _ in range(steps):
        loop.once()
    for _ in range(eng.max_batch):
        if not eng.free:
            break
        loop.once()


def sample(finished, traffic: dict, seed: int):
    """Requests to score: the longest the window finished, then others in
    an order drawn from the seed, until ``sample_tokens`` served tokens
    or ``sample_max_requests`` requests."""
    if not finished:
        return []
    longest = max(range(len(finished)),
                  key=lambda i: len(finished[i].out_tokens))
    rest = [i for i in np.random.default_rng([seed, 7]).permutation(
        len(finished)) if i != longest]
    picked, n = [], 0
    for i in [longest, *rest]:
        picked.append(finished[i])
        n += len(finished[i].out_tokens)
        if (n >= traffic["sample_tokens"]
                or len(picked) >= traffic["sample_max_requests"]):
            break
    return picked


def score(cfg_file, params, picked, device, quant=None, witness=None):
    """(reference logits, served tokens, control logits or None, witness
    logits or None, router margins) of the picked requests."""
    seqs, at, served = [], [], []
    for r in picked:
        prompt = torch.as_tensor(np.asarray(r.tokens), device=device)
        out = torch.as_tensor(np.stack(r.out_tokens), device=device)
        P = prompt.shape[0]
        seqs.append(torch.cat([prompt, out[:-1]]).long())
        at.append(torch.arange(P - 1, P - 1 + out.shape[0], device=device))
        served.append(out if out.dim() == 2 else out[:, None])
    m = cfg_file["model"]
    margins = []
    refs = ref.logits(m, params, seqs, at, margins=margins)
    ctrl = ref.logits(m, params, seqs, at, quant) if quant else None
    wit = ref.logits(m, params, seqs, at, witness) if witness else None
    return refs, served, ctrl, wit, margins


def run(spec, seed: int, seconds: float, traced: bool, device, t_start,
        control: str | None = None, witness: str | None = None):
    """One run of a serving cell. Returns the record the metric readers
    read, and the numbers compared. ``control`` and ``witness`` name a
    precision of the reference (``reference.model``'s ``quant``) read
    beside it for the tokens it puts first, under the prefixes
    ``control_`` and ``witness_``: calibration only."""
    cfg_file, traffic, gen_mod = spec["config"], spec["traffic"], spec["gen"]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from repro_torch.kernels import build
        build.build_all()
        torch.cuda.reset_peak_memory_stats()
    m = cfg_file["model"]
    params = wts.make(m, seed, device)
    eng = build_engine(cfg_file, params, device)
    s = cfg_file["serve"]
    backlog = gen_mod.Backlog(traffic, seed, max_batch=s["max_batch"],
                              max_len=s["max_len"],
                              n_codebooks=m.get("n_codebooks", 1),
                              vocab=m["vocab_size"])
    loop = Loop(eng, backlog, s["prefill_tokens_per_step"])
    rec, finished = window_and_trace(loop, traffic, seconds, traced,
                                     t_start)
    rec["model"] = m
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if on_card else 0)
    picked = sample(finished, traffic, seed)
    del eng, loop, backlog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    refs, served, ctrl, wit, margins = score(cfg_file, params, picked,
                                             device, control, witness)
    gap = check.widest_gap(refs, served) if picked else None
    rec["compared"] = {"served_gap": gap,
                       "scored_requests": len(picked),
                       "scored_tokens": sum(len(r.out_tokens)
                                            for r in picked)}
    if picked:
        rec["compared"].update(check.diagnose(refs, served, margins))
    for name, other in (("control", ctrl), ("witness", wit)):
        if other is not None and picked:
            rec["compared"][f"{name}_gap"] = check.control_gap(refs, other)
            rec["compared"].update(check.diagnose(
                refs, [c.argmax(dim=-1) for c in other], margins,
                f"{name}_"))
    w = rec["window"]
    rec["attempted"] = w["admitted"] + w["rejected"]
    rec["failed"] = w["rejected"]
    return rec


def window_and_trace(loop, traffic, seconds, traced, t_start):
    """Warm up, run the window (and the traced slice). Returns the
    record and the requests the window finished."""
    warm_up(loop, loop.backlog.max_prompt, traffic["warmup_steps"])
    loop.reset()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t1 = t0
    while t1 - t0 < seconds:
        t1 = loop.once()
    window = {"seconds": t1 - t0, "tokens": loop.tokens,
              "ttft_ms": loop.ttft, "itl_ms": loop.itl,
              "admitted": loop.admitted, "rejected": loop.rejected,
              "prompt_tokens": loop.prompt_tokens,
              "prefills": loop.eng.prefills - loop.prefills0,
              "admit_ms": loop.admit_ms, "step_ms": loop.step_ms,
              "finished": len(loop.finished)}
    rec = {"setup_s": setup_s, "window": window}
    finished = list(loop.finished)
    if traced:
        calls = {}
        loop.reset()
        with tr.profiled() as prof, tr.ops_spans(calls):
            tq = time.perf_counter()
            while time.perf_counter() - tq < TRACE_SECONDS:
                loop.once(spans=True)
        t = tr.reduce_events(prof["events"])
        print(f"portbench: traced events {t['kinds']}", file=sys.stderr)
        rec["trace"] = t if "busy_s" in t else None
        rec["calls"] = tr.settle(calls)
    return rec, finished
