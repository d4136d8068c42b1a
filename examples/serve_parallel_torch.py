"""Serving across ranks on the port: one model's heads, MLPs, vocab and
Mamba2 heads split over the ``model`` axis of a mesh (tensor parallelism)
and its experts split over the same axis (``repro_torch.parallel``); with
``--data n`` the engine's slots and each batch's rows split over the
``data`` axis too (mesh (data n, model world / n)).

Every rank runs the same ``Engine`` on the same requests and returns the
same tokens; rank 0 prints them. On N cards, NCCL with a card a rank:

  PYTHONPATH=src torchrun --nproc-per-node N examples/serve_parallel_torch.py

On the CPU, N processes over gloo (no torchrun needed), any smoke arch:

  PYTHONPATH=src python examples/serve_parallel_torch.py --device cpu \
      --world 2 --arch qwen3-14b [--data 2]
"""
from __future__ import annotations

import argparse
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.bridge import init_params
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.lm import LM, Runtime
from repro_torch.serve.engine import Engine, Request


def describe(cfg, lm, rt) -> tuple[str, str]:
    """What a rank holds: its experts (MoE), else its heads; and the
    tensor-parallel split of the dense leaves."""
    tp = rt.tensor(cfg)
    split = [f"attention {'by heads' if tp.attn else 'whole'}",
             f"vocab rows {tp.vocab_rows(cfg)}"]
    if cfg.ssm:
        split.append("Mamba2 heads {} of {}".format(tp.ssm_heads(cfg),
                                                     cfg.n_ssm_heads))
    if cfg.moe:
        moe = next(p["moe"] for p in lm.params["blocks"].values()
                   if "moe" in p)
        held = f"{moe['w_in'].shape[1]} of {cfg.n_experts} experts a rank"
    else:
        held = f"{tp.heads(cfg)} of {cfg.n_heads} heads a rank"
    return held, "; ".join(split)


def serve(rank: int, world: int, args, init_method: str) -> list:
    """One rank: join the world, build the mesh and this rank's weights,
    serve, and return [(rid, tokens)] in finish order."""
    backend = "gloo" if args.device == "cpu" else "nccl"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(args.data, world // args.data, device=args.device)
        cfg = get_smoke_config(args.arch)
        parallel = ParallelConfig()
        gen = torch.Generator(device=mesh.device).manual_seed(0)
        lm = LM(cfg, init_params(cfg, gen, mesh.device, mesh=mesh,
                                 parallel=parallel), device=mesh.device)
        rt = Runtime(parallel, mesh)
        eng = Engine(lm, rt=rt, max_batch=4, max_len=64, device=mesh.device)
        r = np.random.default_rng(0)
        ncb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        plens = (8, 16, 32)       # below or a multiple of the SSD chunk
        done = eng.run([Request(rid=i, tokens=r.integers(
            1, cfg.vocab_size, (plens[i % 3],) + ncb).astype(np.int32),
            max_new_tokens=6) for i in range(6)])
        served = [(q.rid, np.asarray(q.out_tokens).tolist()) for q in done]
        if rank == 0:
            held, split = describe(cfg, lm, rt)
            print(f"{cfg.name} over {world} ranks ({backend}, {held}):")
            print(f"  rank 0: {split}; slots {eng.own.start}-"
                  f"{eng.own.stop - 1} of {eng.max_batch}, "
                  f"{eng.moved_rows} prefill rows moved")
            for rid, toks in served:
                print(f"  request {rid}: {toks}")
        return served
    finally:
        dist.destroy_process_group()


def _spawned(rank, world, args, init_method):
    serve(rank, world, args, init_method)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card (one a rank); 'cpu' runs gloo")
    ap.add_argument("--world", type=int, default=2,
                    help="ranks to spawn when not under torchrun")
    ap.add_argument("--arch", default="arctic-480b",
                    help="a smoke config of repro_torch.configs")
    ap.add_argument("--data", type=int, default=1,
                    help="ranks on the data axis (the batch's); the rest "
                    "go on the model axis")
    args = ap.parse_args(argv)
    if args.data < 1:
        ap.error("--data must be at least 1")
    if "RANK" in os.environ:                       # under torchrun
        return serve(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                     args, "env://")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_spawned, args=(args.world, args, f"tcp://localhost:{port}"),
             nprocs=args.world, join=True)


if __name__ == "__main__":
    main()
