"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the fault-tolerant loop (``train.loop``) on the card, or on the CPU
with ``--device cpu``, with the flags of ``repro.launch.train``. ``--data
N`` trains data-parallel on a world of N ranks (``launch.world.
spawn_world``: gloo on the CPU or when ranks share a card, NCCL with a
card a rank); ``--model-axis M`` splits the model over M ranks of the
``model`` axis as well (heads, MLPs, vocab, Mamba2 heads, experts), on a
world of N x M ranks. ``--data 0``, the default, means the local cards
over M (at least 1), or 1 on the CPU. With ``--smoke`` (the default) the
reduced config trains at sequence 64, batch 8; ``--full`` takes the
published config at ``--shape``. A run resumes from the newest
checkpoint under ``--ckpt-dir``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import (
    ARCHS, SHAPES, ParallelConfig, RunConfig, ShapeConfig, get_config,
    get_smoke_config)
from repro_torch.launch.world import spawn_world
from repro_torch.models.lm import resolve_device
from repro_torch.train.loop import train_loop


def _rank(rank, mesh, rcfg, args):
    """One rank of ``--data N --model-axis M``: the loop on the rank's
    rows and slices."""
    return train_loop(rcfg, ckpt_dir=args.ckpt_dir, num_steps=args.steps,
                      ckpt_every=args.ckpt_every, mesh=mesh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch-train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    ap.add_argument("--data", type=int, default=0,
                    help="data-axis size (0 = the local cards over the "
                         "model axis, 1 on the CPU)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks the model splits over")
    args = ap.parse_args(argv)

    if args.model_axis < 1:
        raise ValueError(f"--model-axis {args.model_axis}: at least 1")
    device = resolve_device(args.device)
    if args.smoke:
        cfg = get_smoke_config(args.arch)
        shape = ShapeConfig("smoke", "train", 64, 8)
        parallel = ParallelConfig(attn_q_chunk=32, attn_kv_chunk=32)
    else:
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]
        parallel = ParallelConfig()
    rcfg = RunConfig(model=cfg, shape=shape, parallel=parallel,
                     total_steps=args.steps)
    model = args.model_axis
    data = args.data or (max(1, torch.cuda.device_count() // model)
                         if device.type == "cuda" else 1)
    print(f"arch={args.arch} params={cfg.param_count() / 1e6:.1f}M "
          f"device={device} data={data} model={model}")
    if data * model > 1:
        world = data * model
        devices = ([str(device)] * world if device.type == "cpu" else None)
        report = spawn_world(world, _rank, rcfg, args, devices=devices,
                             model=model)[0]
    else:
        report = train_loop(rcfg, ckpt_dir=args.ckpt_dir,
                            num_steps=args.steps,
                            ckpt_every=args.ckpt_every, device=device)
    trend = (f"loss {report.losses[0]:.3f} -> {report.final_loss:.3f}"
             if report.losses else f"nothing to run past step {args.steps}")
    print(f"steps={report.steps_run} restarts={report.restarts} {trend}")
    return report


if __name__ == "__main__":
    main()
