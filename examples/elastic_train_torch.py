"""Live DSP elasticity on the port: the paper's policy engine resizing
*real* PyTorch training jobs (``examples/elastic_train.py`` on
``repro_torch``).

Eight slots of one device model an 8-accelerator TRE allocation. Two
training jobs arrive; the DSP scan grows the allocation, the controller
grows a running job into spare slots (checkpoint -> re-enter -> resume,
beyond-paper elastic growth), and an injected preemption is absorbed by
restart-from-checkpoint. The eight slots name one device, so a grown job
runs the same global batch on it, in this process; a pool of distinct
devices would run a grown job's segments as a data-parallel world.

  PYTHONPATH=src python examples/elastic_train_torch.py [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig, RunConfig, ShapeConfig
from repro_torch.core.controller import ElasticController, TrainTask
from repro_torch.core.policy import MgmtPolicy
from repro_torch.core.provision import ProvisionService
from repro_torch.models.lm import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_smoke_config("qwen3-14b")
    shape = ShapeConfig("elastic", "train", 64, 8)
    rcfg = RunConfig(model=cfg, shape=shape,
                     parallel=ParallelConfig(attn_q_chunk=32,
                                             attn_kv_chunk=32),
                     total_steps=1000, learning_rate=1e-3, warmup_steps=5)
    provision = ProvisionService(capacity=8)
    ctl = ElasticController(policy=MgmtPolicy.htc(2, 1.0),
                            provision=provision, devices=[device] * 8,
                            steps_per_tick=5, elastic_grow=True)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [TrainTask(f"train-{i}", rcfg, nodes=2, num_steps=25,
                          ckpt_dir=os.path.join(tmp, f"j{i}"))
                for i in range(2)]
        for j in jobs:
            ctl.submit(j)
        ctl.run(fail_at={3: "train-0"})
        ctl.destroy()
    for j in ctl.finished:
        print(f"{j.name}: steps={j.steps_done} resizes={j.resizes} "
              f"restarts={j.restarts} loss {j.losses[0]:.3f} -> "
              f"{j.losses[-1]:.3f}")
    print(f"TRE billed {provision.node_hours(None, ctl._tick):.0f} "
          f"node-lease-units; {provision.adjust_count()} node adjustments")
    assert all(j.done for j in ctl.finished) and len(ctl.finished) == 2
    assert any(j.resizes > 0 for j in ctl.finished), "no elastic resize ran"
    print("elastic DSP training OK: policies resized live PyTorch jobs")


if __name__ == "__main__":
    main()
