"""MTC serving on the port: a Montage-shaped DAG of inference tasks
through the continuous-batching engine, driven by the trace-rate serve
driver (``examples/serve_workflow.py`` on ``repro_torch``).

The ``MTCRuntimeEnv`` plays the paper's MTC TRE server (trigger monitor +
FCFS + DR1/DR2 negotiation against a shared ``ResourceProvider``), the
port's engine serves the requests through ``TorchEngineAdapter``, and the
driver replays the workflow at trace rate with batched admission and
deferred-grant backpressure. ``benchmarks/torch_serve_fleet.py`` runs the
same driver under the multi-tenant fleet.

  PYTHONPATH=src python examples/serve_workflow_torch.py [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.bridge import init_params
from repro_torch.configs import get_smoke_config
from repro_torch.core.policy import MgmtPolicy
from repro_torch.core.provider import ResourceProvider
from repro_torch.models.lm import LM, resolve_device
from repro_torch.serve.driver import ServeDriver, TorchEngineAdapter
from repro_torch.serve.engine import Engine
from repro_torch.sim.traces import montage_like, request_stream


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config("musicgen-large")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    engine = Engine(LM(cfg, params, device=device), max_batch=4, max_len=48,
                    device=device)

    # a small Montage workflow, marked as an inference request DAG
    wl = montage_like(n_project=8)
    stream = request_stream([wl], period=wl.period, seed=0,
                            seconds_per_token=4.0, prompt_lens=(4, 6))
    provider = ResourceProvider(engine.max_batch, coordination="first-come")
    driver = ServeDriver(
        stream, provider=provider, engine=TorchEngineAdapter(engine, seed=0),
        policy=MgmtPolicy(initial=2, ratio=1.0, scan_interval=3.0,
                          release_interval=60.0),
        name="montage-serve")
    stats = driver.run()
    assert stats.workflows_completed == len(stream), stats
    assert stats.over_admissions == 0

    # dependencies respected in completion order
    pos = {j.jid: i for i, j in enumerate(driver.env.completed)}
    for j in driver.env.completed:
        for d in j.deps:
            assert pos[d] < pos[j.jid]
    print(f"served {stats.tasks_completed} workflow tasks in {engine.steps} "
          f"decode steps (continuous batching, max_batch={engine.max_batch})")
    print(f"slot utilization {stats.slot_utilization:.1%}, "
          f"peak slots {stats.peak_owned}, billed {stats.node_hours:.0f} "
          f"node-hours; trigger-monitor order OK")


if __name__ == "__main__":
    main()
