"""The port's real-engine serve fleet: ``benchmarks/serve_fleet.py --real``
on ``repro_torch``.

    PYTHONPATH=src python benchmarks/torch_serve_fleet.py [--mixes 1 1/2/4]
        [--workflows 1] [--arch musicgen-large] [--smoke] [--device cuda]

For each width mix, one heterogeneous fleet of tenants (one per width of
the mix, each with ``--workflows`` Montage-shaped workflows) runs three
times on the port's DSP control plane (``repro_torch.serve.fleet``):

- on the port's ``Engine`` with a paged KV cache (page size 8), through
  ``TorchEngineAdapter``;
- on the same engine with a contiguous cache, whose decode kernel sweeps
  8 positions a split, as the paged kernel sweeps a page;
- on an ``EmulatedEngine(8, max_len=48)`` twin.

Every ``FleetStats`` field must match between the paged run and the twin
and between paged and contiguous, every request must come out of the
paged and the contiguous run with the same tokens, bit for bit, the
engine's page ledger must equal the fleet pool's after the run, and every
workflow must complete; any mismatch raises. Each mix prints one JSON row with the reference leg's
fields, plus the decode steps and ms per decode step of each engine run.

The engine runs on the card (``--device cuda``, the default; without a
card this raises) or, with ``--device cpu``, on the CPU through the plain
versions of the kernels. Weights are random, drawn from a seeded
``torch.Generator`` on the engine's device. ``--smoke`` takes the arch's
smoke config; without it the arch runs at its published widths and depth.

This module keeps its own copies of ``parse_mix``, ``tenant_streams``,
``tenant_policy``, ``eager_peak_slots`` and ``run_dedicated`` from
``benchmarks/serve_fleet.py``, which imports the JAX package.
``chip_smoke.py`` drives ``fleet_row`` and ``dag_run`` in its dsp phase.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.bridge import init_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.policy import MgmtPolicy
from repro_torch.core.provider import ResourceProvider
from repro_torch.core.provision import ProvisionService
from repro_torch.kernels import ops
from repro_torch.models.lm import LM, resolve_device
from repro_torch.serve.driver import (
    EmulatedEngine, ServeDriver, TorchEngineAdapter)
from repro_torch.serve.engine import Engine
from repro_torch.serve.fleet import ServeFleet, rekey_disjoint
from repro_torch.sim.traces import SERVE_PROFILES, workload_family

#: tokens per KV page of the paged engine and of the fleet's page ledger
PAGE_SIZE = 8
#: the reference leg's engine: 8 batch slots over a 48-token cache
REAL_MAX_BATCH, REAL_MAX_LEN = 8, 48
#: per-tenant DSP policy of the reference leg (priced at each width)
BASE_POLICY = MgmtPolicy(initial=1, ratio=2.0, scan_interval=3.0,
                         release_interval=60.0)
#: the reference leg's defaults, but one workflow per tenant
DEFAULTS = dict(workflows=1, jobs_scale=0.05, period=3600.0, seed=0)


def _require(cond: bool, msg: str) -> None:
    """A check that survives ``python -O`` (unlike assert)."""
    if not cond:
        raise RuntimeError(f"torch_serve_fleet: {msg}")


# ------------------------------------------------- serve_fleet.py copies
def eager_peak_slots(stream) -> int:
    """Peak instantaneous slot demand of the stream under eager execution
    (every task decodes the moment its dependencies finish): the engine
    size a dedicated provider must own to serve with zero queueing delay."""
    events: list[tuple[float, int]] = []
    for t0, jobs in stream:
        start: dict[int, float] = {}
        end: dict[int, float] = {}
        remaining = list(jobs)
        while remaining:
            rest = []
            for j in remaining:
                if all(d in end for d in j.deps):
                    s = max((end[d] for d in j.deps), default=0.0)
                    start[j.jid] = s
                    end[j.jid] = s + max(j.decode_len, 1)
                else:
                    rest.append(j)
            if len(rest) == len(remaining):
                raise ValueError("dependency cycle in stream entry")
            remaining = rest
        for j in jobs:
            events.append((t0 + start[j.jid], 1))
            events.append((t0 + end[j.jid], -1))
    events.sort()
    peak = level = 0
    for _, d in events:
        level += d
        peak = max(peak, level)
    return max(peak, 1)


def parse_mix(spec: str) -> list[int]:
    """``"1/2/4"`` -> ``[1, 2, 4]`` (widths cycled across the tenants);
    every width must name a ``SERVE_PROFILES`` model class."""
    widths = [int(tok) for tok in spec.replace(",", "/").split("/") if tok]
    if not widths:
        raise ValueError(f"empty width mix {spec!r}")
    unknown = [w for w in widths if w not in SERVE_PROFILES]
    if unknown:
        raise ValueError(f"no serve profile for widths {unknown} "
                         f"(known: {sorted(SERVE_PROFILES)})")
    return widths


def tenant_streams(n_tenants: int, workflows: int, seed: int,
                   jobs_scale: float, period: float,
                   mix: list[int] | None = None):
    """One workflow arrival stream per tenant (disjoint jid ranges), each a
    seeded ``workload_family`` of Montage-shaped mosaics marked by its
    width class's serve profile (cycled through ``mix``). Returns
    ``(streams, widths)``."""
    mix = mix or [1]
    streams, widths = [], []
    for t in range(n_tenants):
        fam = workload_family(0, workflows, seed=seed * 1009 + t,
                              jobs_scale=jobs_scale)
        profile = SERVE_PROFILES[mix[t % len(mix)]]
        streams.append(profile.stream(fam, period=period, seed=seed + t))
        widths.append(profile.width)
    return rekey_disjoint(streams), widths


def tenant_policy(base: MgmtPolicy, width: int) -> MgmtPolicy:
    """The fleet policy priced at the tenant's width (B in node units)."""
    return MgmtPolicy(initial=base.initial * width, ratio=base.ratio,
                      scan_interval=base.scan_interval,
                      release_interval=base.release_interval)


def run_dedicated(streams, widths, *, policy: MgmtPolicy,
                  max_len: int | None = None) -> dict:
    """N dedicated engines: per-tenant fixed width-sized slots, no
    negotiation; a width-w tenant's engine bills w units per slot.
    ``max_len`` caps decode marks to a cache depth, as the real engine
    does."""
    t0 = time.perf_counter()
    total = {"node_hours": 0.0, "slots": 0, "workflows": 0, "tasks": 0,
             "over_admissions": 0, "busy": 0.0, "owned": 0.0,
             "makespan_s": 0.0}
    for i, (stream, w) in enumerate(zip(streams, widths)):
        slots = max(eager_peak_slots(stream), policy.initial)
        drv = ServeDriver(stream, provider=ProvisionService(),
                          engine=EmulatedEngine(slots, max_len=max_len),
                          fixed_nodes=slots * w, slot_width=w,
                          name=f"dedicated-t{i}")
        st = drv.run()
        _require(st.workflows_completed == st.workflows_expected,
                 f"dedicated tenant {i} completed {st.workflows_completed}"
                 f"/{st.workflows_expected} workflows")
        _require(st.over_admissions == 0,
                 f"dedicated tenant {i} over-admitted {st.over_admissions}")
        total["node_hours"] += st.node_hours
        total["slots"] += slots * w
        total["workflows"] += st.workflows_completed
        total["tasks"] += st.tasks_completed
        total["busy"] += st.busy_node_ticks
        total["owned"] += st.owned_node_ticks
        total["makespan_s"] = max(total["makespan_s"], st.makespan_s)
    total["slot_utilization"] = (total["busy"] / total["owned"]
                                 if total["owned"] else 0.0)
    total["wall_s"] = time.perf_counter() - t0
    return total


# ------------------------------------------------------------ the engine
def build_lm(arch: str, *, smoke: bool, device: str, seed: int = 0) -> LM:
    """The arch at its published widths and depth (or its smoke config),
    random weights from a ``torch.Generator`` seeded on ``device``."""
    device = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    return LM(cfg, init_params(cfg, gen, device), device=device)


def build_engine(lm: LM, page_size: int | None) -> Engine:
    """Paged at ``page_size``, or contiguous (None) with the decode kernel's
    split at ``PAGE_SIZE`` positions: both then decode the same bits."""
    return Engine(lm, max_batch=REAL_MAX_BATCH, max_len=REAL_MAX_LEN,
                  page_size=page_size, decode_block_s=PAGE_SIZE,
                  device=lm.device)


class TokenLog(TorchEngineAdapter):
    """``TorchEngineAdapter`` that keeps each finished request's rid and
    tokens, in the order the engine finishes them."""

    def __init__(self, engine, *, seed: int = 0):
        super().__init__(engine, seed=seed)
        self.finished: list[tuple[int, np.ndarray]] = []

    def step(self) -> list[int]:
        done = self.engine.step()
        self.finished += [(r.rid, np.asarray(r.out_tokens)) for r in done]
        return [r.rid for r in done]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------- the runs
def _fleet(engine, mix_spec: str, *, workflows: int, seed: int,
           jobs_scale: float, period: float, page_size: int | None):
    mix = parse_mix(mix_spec)
    streams, widths = tenant_streams(len(mix), workflows, seed, jobs_scale,
                                     period, mix=mix)
    return ServeFleet(streams, engine=engine, coordination="coordinated",
                      policies=[tenant_policy(BASE_POLICY, w)
                                for w in widths],
                      widths=widths, event_skip=False,
                      # one name for the paged, contiguous and emulated
                      # runs: stats must match field for field, labels too
                      name="real-fleet", page_size=page_size), widths


def engine_fleet_run(engine: Engine, mix_spec: str, *, seed: int,
                     **kw) -> tuple[dict, dict]:
    """One fleet over ``engine`` through ``TorchEngineAdapter``. Returns
    ``(FleetStats.as_dict(), extras)``; raises if a workflow is left
    undone or, on a paged engine, if the engine's page ledger and the
    pool's disagree after the run. The kernels' launch counters are set
    to 0 just before the run and read just after (``extras["launches"]``:
    all 0 on the CPU, where the plain versions run); ``extras["tokens"]``
    lists each finished request's (rid, tokens) in finishing order."""
    page_size = engine.page_size
    adapter = TokenLog(engine, seed=seed)
    fleet, widths = _fleet(adapter, mix_spec, seed=seed, page_size=page_size,
                           **kw)
    steps0, prefills0 = engine.steps, engine.prefills
    _sync(engine.device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    fs = fleet.run()
    _sync(engine.device)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    steps = engine.steps - steps0
    _require(fs.workflows_completed == fs.workflows_expected,
             f"mix={mix_spec} paged={page_size is not None} completed "
             f"{fs.workflows_completed}/{fs.workflows_expected}")
    _require(not engine.active and len(engine.free) == engine.max_batch,
             f"mix={mix_spec}: engine slots not all freed")
    extras = {"wall_s": wall, "decode_steps": steps, "widths": widths,
              "prefills": engine.prefills - prefills0, "launches": launches,
              "ms_per_decode_step": 1e3 * wall / max(steps, 1),
              "tokens": adapter.finished}
    if page_size is not None:
        fleet.pool.pager.check_conservation()
        engine.pager.check_conservation()
        _require(engine.pager.used_pages == fleet.pool.pager.used_pages,
                 "engine/pool page ledgers diverged post-run")
        extras["pool_pages"] = fleet.pool.pager.capacity_pages
        extras["peak_pages_used"] = fleet.pool.pager.peak_used
    return fs.as_dict(), extras


def twin_fleet_run(mix_spec: str, **kw) -> tuple[dict, int]:
    """The same fleet on an ``EmulatedEngine(8, max_len=48)`` twin:
    ``(FleetStats.as_dict(), decode steps)``."""
    twin = EmulatedEngine(REAL_MAX_BATCH, max_len=REAL_MAX_LEN)
    fleet, _ = _fleet(twin, mix_spec, page_size=PAGE_SIZE, **kw)
    return fleet.run().as_dict(), twin.steps


def fleet_row(lm: LM, mix_spec: str, *, workflows: int = 1, seed: int = 0,
              jobs_scale: float = 0.05, period: float = 3600.0) -> dict:
    """The reference leg's row for one mix: the fleet paged, contiguous and
    on its emulated twin, and the dedicated baseline. Raises on any
    parity or paged-vs-contiguous mismatch (stats, or any request's
    tokens), any over-admission or isolation violation, or a decode-step
    count that differs from the twin's."""
    kw = dict(workflows=workflows, seed=seed, jobs_scale=jobs_scale,
              period=period)
    runs = {}
    for mode, ps in (("paged", PAGE_SIZE), ("contiguous", None)):
        engine = build_engine(lm, ps)
        runs[mode] = engine_fleet_run(engine, mix_spec, **kw)
        del engine       # one engine's caches resident at a time
    (paged, paged_x), (contig, contig_x) = runs["paged"], runs["contiguous"]
    emu, emu_steps = twin_fleet_run(mix_spec, **kw)
    mix = parse_mix(mix_spec)
    streams, widths = tenant_streams(len(mix), workflows, seed, jobs_scale,
                                     period, mix=mix)
    dedicated = run_dedicated(streams, widths, policy=BASE_POLICY,
                              max_len=REAL_MAX_LEN)
    parity = [k for k in emu if emu[k] != paged.get(k)]
    pvc = [k for k in paged if paged[k] != contig.get(k)]
    p_toks, c_toks = paged_x["tokens"], contig_x["tokens"]
    token_mismatches = abs(len(p_toks) - len(c_toks)) + sum(
        pr != cr or not np.array_equal(pt, ct)
        for (pr, pt), (cr, ct) in zip(p_toks, c_toks))
    row = {
        "mix": mix_spec,
        "n_tenants": len(mix),
        "widths": paged_x["widths"],
        "workflows": paged["workflows_completed"],
        "tasks": paged["tasks_completed"],
        "parity_mismatches": len(parity),
        "parity_fields": parity,
        "paged_vs_contiguous_mismatches": len(pvc),
        "paged_vs_contiguous_fields": pvc,
        "requests": len(p_toks),
        "tokens_out": int(sum(t.shape[0] for _, t in p_toks)),
        "token_mismatches": token_mismatches,
        "over_admissions": paged["over_admissions"],
        "isolation_violations": paged["isolation_violations"],
        "billed_node_hours": paged["node_hours"],
        "dedicated_node_hours": dedicated["node_hours"],
        "billed_vs_dedicated": (paged["node_hours"]
                                / max(dedicated["node_hours"], 1e-12)),
        "page_size": PAGE_SIZE,
        "pool_pages": paged_x["pool_pages"],
        "peak_pages_used": paged_x["peak_pages_used"],
        "decode_steps": paged_x["decode_steps"],
        "contiguous_decode_steps": contig_x["decode_steps"],
        "twin_decode_steps": emu_steps,
        "wall_s": paged_x["wall_s"],
        "contiguous_wall_s": contig_x["wall_s"],
        "ms_per_decode_step": paged_x["ms_per_decode_step"],
        "contiguous_ms_per_decode_step": contig_x["ms_per_decode_step"],
        "decode_steps_per_sec": (paged_x["decode_steps"]
                                 / max(paged_x["wall_s"], 1e-12)),
        "prefills": paged_x["prefills"],
        "contiguous_prefills": contig_x["prefills"],
        "launches": paged_x["launches"],
        "contiguous_launches": contig_x["launches"],
    }
    _require(not parity, f"emulator-vs-real stats diverged on {parity} "
             f"(mix={mix_spec})")
    _require(not pvc, f"paged-vs-contiguous stats diverged on {pvc} "
             f"(mix={mix_spec})")
    _require(token_mismatches == 0, f"mix={mix_spec}: {token_mismatches} "
             f"of {len(p_toks)} requests served other tokens paged than "
             "contiguous")
    _require(row["over_admissions"] == 0 and row["isolation_violations"] == 0,
             f"mix={mix_spec}: {row['over_admissions']} over-admissions, "
             f"{row['isolation_violations']} isolation violations")
    _require(row["decode_steps"] == row["contiguous_decode_steps"] == emu_steps,
             f"mix={mix_spec}: decode steps paged {row['decode_steps']}, "
             f"contiguous {row['contiguous_decode_steps']}, twin {emu_steps}")
    return row


def dag_run(engine, *, seed: int = 0, jobs_scale: float = 0.05,
            period: float = 3600.0) -> tuple[dict, dict, list]:
    """One Montage-shaped workflow (``workload_family``, marked by the
    width-1 serve profile) served by ``ServeDriver`` over ``engine`` (an
    ``Engine``, wrapped in ``TorchEngineAdapter``, or an
    ``EmulatedEngine``) under a first-come ``ResourceProvider`` of the
    engine's capacity. Returns ``(ServeStats.as_dict(), {task: (start,
    finish)}, completion order)``."""
    (stream,), _ = tenant_streams(1, 1, seed, jobs_scale, period, mix=[1])
    adapter = (engine if isinstance(engine, EmulatedEngine)
               else TorchEngineAdapter(engine, seed=seed))
    drv = ServeDriver(stream, provider=ResourceProvider(
        adapter.capacity, coordination="first-come"), engine=adapter,
        policy=MgmtPolicy(initial=2, ratio=1.0, scan_interval=3.0,
                          release_interval=60.0))
    stats = drv.run()
    jobs = [j for _, js in stream for j in js]
    _require(stats.tasks_completed == len(jobs),
             f"DAG: {stats.tasks_completed} of {len(jobs)} tasks completed")
    _require(stats.over_admissions == 0,
             f"DAG: {stats.over_admissions} over-admissions")
    pos = {j.jid: i for i, j in enumerate(drv.env.completed)}
    for j in drv.env.completed:
        _require(all(pos[d] < pos[j.jid] for d in j.deps),
                 f"DAG: task {j.jid} completed before a dependency")
    return (stats.as_dict(), {j.jid: (j.start, j.finish) for j in jobs},
            [j.jid for j in drv.env.completed])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mixes", nargs="+", default=["1", "1/2/4"])
    ap.add_argument("--workflows", type=int, default=DEFAULTS["workflows"],
                    help="workflows per tenant")
    ap.add_argument("--jobs-scale", type=float,
                    default=DEFAULTS["jobs_scale"])
    ap.add_argument("--period", type=float, default=DEFAULTS["period"])
    ap.add_argument("--seed", type=int, default=DEFAULTS["seed"])
    ap.add_argument("--arch", default="musicgen-large")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (default: published "
                         "widths and depth)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    lm = build_lm(args.arch, smoke=args.smoke, device=args.device)
    device = (torch.cuda.get_device_name(0) if args.device == "cuda"
              else "cpu")
    for mix_spec in args.mixes:
        row = fleet_row(lm, mix_spec, workflows=args.workflows,
                        seed=args.seed, jobs_scale=args.jobs_scale,
                        period=args.period)
        row.update(arch=lm.cfg.name, smoke=args.smoke, device=device,
                   max_batch=REAL_MAX_BATCH, max_len=REAL_MAX_LEN)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
