"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Brings up the continuous-batching engine on the card (or on the CPU with
``--device cpu``) with weights drawn from seed 0, serves a synthetic
request stream and reports throughput. ``--full`` serves the published
widths and depth; the default is the reduced smoke config.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.bridge import init_params
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.models.lm import LM, resolve_device
from repro_torch.serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="published config instead of the smoke reduction")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain path")
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged KV cache with pages of this many tokens")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    lm = LM(cfg, init_params(cfg, gen, device), device=device)
    engine = Engine(lm, max_batch=args.max_batch, max_len=args.max_len,
                    page_size=args.page_size, device=device)
    rng = np.random.default_rng(0)

    def make_req(i):
        shape = ((args.prompt_len,) if cfg.n_codebooks <= 1
                 else (args.prompt_len, cfg.n_codebooks))
        req = Request(rid=i, tokens=rng.integers(
            1, cfg.vocab_size, shape).astype(np.int32),
            max_new_tokens=args.new_tokens)
        if cfg.vision_stub:
            req.patches = rng.standard_normal(
                (cfg.n_patches, cfg.d_model)).astype(np.float32)
        return req

    reqs = [make_req(i) for i in range(args.requests)]
    t0 = time.perf_counter()
    done = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={args.arch} ({cfg.name}, {where}): served {len(done)} "
          f"requests, {toks} tokens in {dt:.3f}s ({toks / dt:.1f} tok/s, "
          f"{engine.steps} decode steps, {engine.prefills} prefills)")


if __name__ == "__main__":
    main()
