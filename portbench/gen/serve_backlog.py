"""A closed backlog of workflow tasks, each task one inference request.

The traffic file names the workflow template (``gen/<workflow>.py``) and
the laws of the lengths. Every task of a workflow is one request: its
output length is ``tokens_per_paper_second`` times the task's runtime in
the paper's seconds (drawn lognormal for the parallel stages, fixed for
the serial ones), its prompt length is drawn lognormal and truncated, and
the output is clipped so that the request fits ``max_len``. A task is
ready when its parents have finished. Whenever fewer than
``ready_per_slot * max_batch`` tasks are ready a new workflow starts, so
the engine never runs dry: the way a DSP runtime environment dispatches
ready tasks to the nodes it holds. A step admits ready tasks first come
first served into free slots while their prompts add up to at most a
prefill budget, a setting of the serving deployment (its
configuration's ``serve.prefill_tokens_per_step``), not of the traffic.

The lengths of a pool of workflows come from the traffic's own
``size_seed``, the same for every run; ``--seed`` orders the pool and
draws the prompts' token ids. So every seed serves the same sizes in
another order. The first workflows start at staggered stages (workflow k
at stage k mod 9, its earlier stages taken as done), as in a provider
that has been serving for a while, so the long serial stages are in
flight from the start.
"""
from __future__ import annotations

import importlib
from collections import deque
from dataclasses import dataclass

import numpy as np

KIND = "serve"


@dataclass
class Task:
    rid: int
    stage: str
    prompt: np.ndarray          # (P,) or (P, ncb) int32
    max_new: int
    workflow: int
    index: int                  # task index in the workflow's template


class Backlog:
    def __init__(self, params: dict, seed: int, *, max_batch: int,
                 max_len: int, n_codebooks: int, vocab: int):
        tmpl_mod = importlib.import_module(f"gen.{params['workflow']}")
        self.tmpl = tmpl_mod.template(params["n_project"])
        self.stage_names = tmpl_mod.STAGES
        self.pool = draw_pool(params, self.tmpl, max_len)
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(len(self.pool[0]))
        self.ncb, self.vocab = n_codebooks, vocab
        self.target = params["ready_per_slot"] * max_batch
        self.children = [[] for _ in self.tmpl.stage]
        for i, dd in enumerate(self.tmpl.deps):
            for d in dd:
                self.children[d].append(i)
        self.ready: deque[Task] = deque()
        self.waiting: dict[tuple[int, int], int] = {}   # (wf, task) -> parents left
        self.n_workflows = 0
        self.next_rid = 0
        n_stages = len(self.stage_names)
        while len(self.ready) < self.target:
            self._start(self.n_workflows % n_stages)
        self.max_prompt = int(self.pool[0].max())

    def _task(self, wf: int, i: int) -> Task:
        plen, olen = self.pool[0][self.order[wf % len(self.order)], i], \
            self.pool[1][self.order[wf % len(self.order)], i]
        shape = (int(plen),) if self.ncb <= 1 else (int(plen), self.ncb)
        toks = self.rng.integers(0, self.vocab, shape, dtype=np.int32)
        self.next_rid += 1
        return Task(self.next_rid - 1,
                    self.stage_names[self.tmpl.stage[i]], toks, int(olen),
                    wf, i)

    def _start(self, stage: int) -> None:
        """A new workflow whose stages before ``stage`` are done."""
        wf = self.n_workflows
        self.n_workflows += 1
        for i, dd in enumerate(self.tmpl.deps):
            if self.tmpl.stage[i] < stage:
                continue
            left = sum(self.tmpl.stage[d] >= stage for d in dd)
            if left:
                self.waiting[(wf, i)] = left
            else:
                self.ready.append(self._task(wf, i))

    def take(self, n: int, tokens: int) -> list[Task]:
        """Up to ``n`` ready tasks, first come first served, while their
        prompts add up to at most ``tokens`` (the first always goes)."""
        out, used = [], 0
        while self.ready and len(out) < n:
            plen = len(self.ready[0].prompt)
            if out and used + plen > tokens:
                break
            used += plen
            out.append(self.ready.popleft())
        return out

    def done(self, task: Task) -> None:
        """``task`` finished: release its children, top the backlog up."""
        for c in self.children[task.index]:
            key = (task.workflow, c)
            self.waiting[key] -= 1
            if not self.waiting[key]:
                del self.waiting[key]
                self.ready.append(self._task(task.workflow, c))
        while len(self.ready) < self.target:
            self._start(0)


def truncated_lognormal(rng, law: dict, shape):
    """Whole lengths from a lognormal, each outside [min, max] drawn
    again: a clip would pile lengths up on its bounds, and equal lengths
    are prefilled together, so the law stays continuous."""
    out = np.zeros(shape, np.int64)
    todo = np.ones(shape, bool)
    while todo.any():
        x = np.round(rng.lognormal(np.log(law["median"]), law["sigma"],
                                   int(todo.sum())))
        out[todo] = x
        todo = (out < law["min"]) | (out > law["max"])
    return out


def draw_pool(params: dict, tmpl, max_len: int):
    """(prompt lengths, output lengths), each (pool_workflows, tasks),
    from the traffic's ``size_seed``."""
    rng = np.random.default_rng(params["size_seed"])
    n, m = params["pool_workflows"], len(tmpl.stage)
    par = params["parallel_runtime"]
    rt = np.array([np.nan if r is None else r for r in tmpl.runtime])
    runtime = np.broadcast_to(rt, (n, m)).copy()
    drawn = np.isnan(rt)
    runtime[:, drawn] = rng.lognormal(np.log(par["median"]), par["sigma"],
                                      (n, int(drawn.sum())))
    out = np.maximum(np.round(params["tokens_per_paper_second"] * runtime),
                     1).astype(np.int64)
    prompt = truncated_lognormal(rng, params["prompt"], (n, m))
    out = np.minimum(out, max_len - prompt)
    if (out < 1).any():
        raise ValueError("a prompt leaves no room for output in max_len")
    return prompt, out
