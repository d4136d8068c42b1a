"""Quickstart on the port: train a small decoder LM end to end with the
public API (``examples/quickstart.py`` on ``repro_torch``).

config -> model -> fault-tolerant training loop (checkpoints and
auto-resume) -> the loss curve, on the card (or the CPU with ``--device
cpu``), on one rank, data-parallel over ``--data`` ranks, split over
``--model-axis`` ranks (heads, MLP, vocab), or both: gloo on the CPU or
where ranks share a card, NCCL with a card a rank. The model is a
reduced granite-family decoder; ``--preset 100m`` is a ~100M-parameter
run on the same path.

  PYTHONPATH=src python examples/quickstart_torch.py --steps 60
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --data 2
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --model-axis 2
  PYTHONPATH=src python examples/quickstart_torch.py --preset 100m --steps 300
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig, RunConfig, ShapeConfig
from repro_torch.launch.world import spawn_world
from repro_torch.models.lm import resolve_device
from repro_torch.train.loop import train_loop

PRESETS = {
    # ~8M params: CPU-friendly sanity run
    "tiny": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                 head_dim=32, d_ff=512, vocab_size=2048),
    # ~100M params: the "real" quickstart (minutes a step on the CPU)
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab_size=32000),
}


def _rank(rank, mesh, rcfg, steps, ckpt_dir):
    """One rank of ``--data N --model-axis M``: the loop on the rank's
    rows and slices."""
    return train_loop(rcfg, ckpt_dir=ckpt_dir, num_steps=steps,
                      ckpt_every=max(steps // 4, 1), mesh=mesh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel ranks (the batch must divide)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks the model splits over")
    args = ap.parse_args(argv)
    world = args.data * args.model_axis

    device = resolve_device(args.device)
    cfg = dataclasses.replace(get_config("granite-3-8b"),
                              name=f"quickstart-{args.preset}",
                              **PRESETS[args.preset])
    shape = ShapeConfig("quickstart", "train", args.seq, args.batch)
    rcfg = RunConfig(model=cfg, shape=shape,
                     parallel=ParallelConfig(attn_q_chunk=128,
                                             attn_kv_chunk=128),
                     learning_rate=1e-3, warmup_steps=10,
                     total_steps=args.steps)
    print(f"model: {cfg.param_count()/1e6:.1f}M params, "
          f"{shape.tokens} tokens/step, {world} rank(s) on {device} "
          f"(data {args.data}, model {args.model_axis})")
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch-quickstart")
    if world > 1:
        devices = [str(device)] * world if device.type == "cpu" else None
        report = spawn_world(world, _rank, rcfg, args.steps, ckpt_dir,
                             devices=devices, model=args.model_axis)[0]
    else:
        report = train_loop(rcfg, ckpt_dir=ckpt_dir, num_steps=args.steps,
                            ckpt_every=max(args.steps // 4, 1),
                            device=device)
    print(f"ran {report.steps_run} steps; "
          f"loss {report.losses[0]:.3f} -> {report.final_loss:.3f}")
    assert report.final_loss < report.losses[0], "loss did not decrease"
    print(f"checkpoints under {ckpt_dir}")
    return report


if __name__ == "__main__":
    main()
