"""The 9-stage Montage mosaic template, frozen for the benchmark.

A copy of the shape of ``repro_torch.sim.traces._montage_template``: the
stage of every task, its runtime in the paper's seconds (None for the
parallel stages, whose runtimes are drawn) and its parents. The
benchmark keeps its own copy so that a change to the program's traces
cannot move the yardstick.
"""
from __future__ import annotations

from typing import NamedTuple

STAGES = ("mProjectPP", "mDiffFit", "mConcatFit", "mBgModel", "mBackground",
          "mImgtbl", "mAdd", "mShrink", "mJPEG")
SERIAL_RUNTIME = {"mConcatFit": 110.0, "mBgModel": 125.0, "mImgtbl": 35.0,
                  "mAdd": 45.0, "mShrink": 20.0, "mJPEG": 15.0}


class Template(NamedTuple):
    stage: tuple[int, ...]            # index into STAGES, per task
    runtime: tuple[float | None, ...]  # None: drawn (parallel stage)
    deps: tuple[tuple[int, ...], ...]  # parents, as task indices


def template(n_project: int) -> Template:
    """The mosaic at width ``n_project``: ``6 * n_project + 4`` tasks,
    ``4 * n_project - 2`` of them mDiffFit, each serial stage one task."""
    stage, runtime, deps = [], [], []

    def add(s: str, dd) -> int:
        stage.append(STAGES.index(s))
        runtime.append(SERIAL_RUNTIME.get(s))
        deps.append(tuple(dd))
        return len(stage) - 1

    project = [add("mProjectPP", ()) for _ in range(n_project)]
    diff = []
    for i in range(4 * n_project - 2):
        a = project[i % n_project]
        b = project[(i + 1 + i // n_project) % n_project]
        diff.append(add("mDiffFit", (a,) if a == b else (a, b)))
    concat = add("mConcatFit", diff)
    bgmodel = add("mBgModel", (concat,))
    background = [add("mBackground", (bgmodel, project[i]))
                  for i in range(n_project)]
    imgtbl = add("mImgtbl", background)
    madd = add("mAdd", (imgtbl,))
    shrink = add("mShrink", (madd,))
    add("mJPEG", (shrink,))
    if len(stage) != 6 * n_project + 4:
        raise RuntimeError(f"montage template: {len(stage)} tasks, not "
                           f"6*{n_project}+4")
    return Template(tuple(stage), tuple(runtime), tuple(deps))
