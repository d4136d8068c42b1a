"""The traced slice of a run: spans around the calls into the port,
``torch.profiler`` over them, and the reduction of its raw events.

Spans are ``record_function`` ranges opened from the benchmark's own
files: ``pb.step`` around ``Engine.step``, ``pb.admit`` around
``Engine.admit_many``, and, while
``ops_spans`` is open, ``pb.op.<fn>`` around every call of
``repro_torch.kernels.ops.<fn>``, wrapped at the module attribute that
the models call through. Each wrapped call also keeps what its cost
needs: its shapes, and the small data tensors (lengths, counts) that
decide its work, read only after the slice so nothing syncs inside it.

The reduction reads the profiler's raw kineto events: a device kernel
belongs to the span that holds the host call that launched it (matched
by correlation id), the device's busy time is the union of its kernel,
copy and set intervals, and its idle gaps are labelled by the span the
host was in at their midpoint.
"""
from __future__ import annotations

import bisect
import contextlib

import torch

OPS = ("attention", "paged_decode", "gmm", "decode", "ssd")
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
NAME_CHARS = 120      # a kernel's name in the breakdown, cut to this


def _capture(name, args):
    """What the cost of one ``ops.<name>`` call needs, from its
    arguments; tensors here are read after the slice."""
    t = [a for a in args if isinstance(a, torch.Tensor)]
    rec = {"dtype_bytes": t[0].element_size(),
           "shapes": [tuple(a.shape) for a in t]}
    if name == "paged_decode":
        rec["lengths"] = t[4]
    elif name == "gmm" and len(t) > 2:
        rec["counts"] = t[2]
    elif name == "decode":
        rec["lengths"] = t[3]
    return rec


@contextlib.contextmanager
def ops_spans(calls: dict):
    """Wrap ``repro_torch.kernels.ops``'s functions: each call runs in a
    ``pb.op.<fn>`` span and appends its capture to ``calls[fn]``."""
    from torch.profiler import record_function

    from repro_torch.kernels import ops
    saved = {n: getattr(ops, n) for n in OPS}

    def wrap(name, fn):
        def call(*args, **kw):
            calls.setdefault(name, []).append(_capture(name, args))
            with record_function(f"pb.op.{name}"):
                return fn(*args, **kw)
        return call

    for n, fn in saved.items():
        setattr(ops, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def settle(calls: dict) -> dict:
    """Replace each capture's data tensors by the numbers they hold."""
    for recs in calls.values():
        for r in recs:
            if "lengths" in r:
                ln = r.pop("lengths").long()
                r["positions"] = int(ln.sum())
                r["lengths_list"] = ln.tolist()
            if "counts" in r:
                c = r.pop("counts").long()
                r["live"] = int((c > 0).sum())
                r["rows"] = int(c.sum())
    return calls


class Spans:
    """Non-overlapping host spans of one kind, searchable by time."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _, _ in self.spans]

    def find(self, t: int):
        """Index of the span holding time ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][1] >= t:
            return i
        return None


def kind_of(e) -> str:
    """The kineto activity kind of an event, from its device and name
    (the events of torch 2.11 carry no activity type): runtime and driver
    calls are named ``cuda*`` / ``cu*``; device copies ``Memcpy*``, sets
    ``Memset*``; the device copies of ``pb.`` annotations are
    annotations."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if name.startswith("pb."):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith("pb."):
        return "user_annotation"
    if name.startswith("cu") and "::" not in name:
        return "cuda_runtime"
    return "cpu_op"


def start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1e3)


def duration_ns(e) -> int:
    if hasattr(e, "duration_ns"):
        return e.duration_ns()
    return int(e.duration_us() * 1e3)


def reduce_events(events, window_name="pb.traced"):
    """Reduce kineto events to the traced slice's numbers.

    Returns {"window_s", "busy_s", "kernels": {span kind: count},
    "ops": {fn: [device seconds of each call, in call order]},
    "device_ops": [[name, s], ...] (top 10), "idle_gaps": [[host span,
    s], ...] (top 10), "spans": {kind: count}, "kinds": {event kind:
    count}}; only "kinds" when the profiler saw no device activity."""
    runtime, device, annot = {}, [], {}
    kinds: dict[str, int] = {}
    for e in events:
        kind = kind_of(e)
        kinds[kind] = kinds.get(kind, 0) + 1
        s0 = start_ns(e)
        if kind == "cuda_runtime":
            runtime[e.correlation_id()] = s0
        elif kind in DEVICE_KINDS:
            device.append((s0, s0 + duration_ns(e), e.name(), kind,
                           e.correlation_id() or e.linked_correlation_id()))
        elif kind == "user_annotation" and e.name().startswith("pb."):
            annot.setdefault(e.name(), []).append(
                (s0, s0 + duration_ns(e), e.name()))
    if not device or window_name not in annot:
        return {"kinds": kinds}
    w0, w1 = annot[window_name][0][:2]
    outer = Spans([s for n, v in annot.items() for s in v
                   if n in ("pb.step", "pb.admit")])
    ops = {n.removeprefix("pb.op."): Spans(v) for n, v in annot.items()
           if n.startswith("pb.op.")}
    per_op = {n: [0.0] * len(s.spans) for n, s in ops.items()}
    kernels: dict[str, int] = {}
    by_name: dict[str, float] = {}
    for s, t, name, kind, corr in device:
        if t < w0 or s > w1:
            continue
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
        launched = runtime.get(corr)
        if launched is None:
            continue
        if kind == "kernel":
            i = outer.find(launched)
            where = outer.spans[i][2] if i is not None else "other"
            kernels[where] = kernels.get(where, 0) + 1
        for n, sp in ops.items():
            i = sp.find(launched)
            if i is not None:
                per_op[n][i] += (t - s) / 1e9
                break
    # busy: the union of device intervals inside the window
    busy, gaps = 0.0, []
    cur0, cur1 = None, w0
    for s, t, *_ in sorted(device):
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if s > cur1:
            if cur0 is not None:
                busy += (cur1 - cur0) / 1e9
            gaps.append((cur1, s))
            cur0, cur1 = s, t
        else:
            cur0 = s if cur0 is None else cur0
            cur1 = max(cur1, t)
    if cur0 is not None:
        busy += (cur1 - cur0) / 1e9
    if cur1 < w1:
        gaps.append((cur1, w1))
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        label = "harness"
        for n, sp in ops.items():
            if sp.find(mid) is not None:
                label = f"pb.op.{n}"
                break
        else:
            i = outer.find(mid)
            if i is not None:
                label = outer.spans[i][2]
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy, "kinds": kinds,
            "kernels": kernels, "ops": per_op,
            "spans": {n: len(v) for n, v in annot.items()},
            "device_ops": [[n[:NAME_CHARS], v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:10]]}


@contextlib.contextmanager
def profiled():
    """``torch.profiler`` over the CPU and the card; yields a dict that
    holds the kineto events once the block has closed."""
    from torch.profiler import ProfilerActivity, profile, record_function
    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("pb.traced"):
            yield out
            torch.cuda.synchronize()
    out["events"] = prof.profiler.kineto_results.events()
