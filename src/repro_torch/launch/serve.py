"""Batched serving driver: prefill + decode loop with timing (counterpart of
``repro/launch/serve.py``, with the reference's flags).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --smoke \\
      --batch 4 --prompt-len 64 --gen 32 --kv-compress 16

Runs on the card (``--device cpu`` runs on the CPU). MoE archs
(``--arch deepseek-v2-lite-16b``, ``kimi-k2-1t-a32b``) serve through the
dropless MoE path (``dense_moe=True``), as the reference CLI does.
A vision arch (``--arch llama-3.2-vision-90b``) gets synthetic patch
embeddings from the modality stub, passed to ``generate`` as ``vision``.
``--smoke`` is the reference's flag as it is: ``store_true`` with
``default=True``, so the command line always serves the arch's
``smoke_config()`` (``ROADMAP.md`` §3, behaviour of the reference).

``--mesh d x m`` lays the process group's ranks out as the reference's
(data, model) mesh (``launch/mesh.py``), as the train CLI does: ``1x1`` in
one process; else the ranks ``torchrun`` starts (NCCL on the card, one rank
a card; gloo on the CPU) or a default group the caller made (gloo ranks
sharing one card). The default is the world by 1. Every rank draws the
whole weights from the seed and keeps its blocks (``shard_params``); each
data rank serves its rows of the seeded prompt (and of the vision stub's
embeddings); ``m > 1`` is tensor parallelism of every arch, its decode
loop eager. Rank 0 prints the mesh, the decode route and its rows'
tokens.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_arch
from ..device import generator, resolve_device
from ..distributed import ParallelismRules, activation_sharding, shard_batch, shard_params
from ..models import init_params, param_count
from ..models.modality import synth_patch_embeddings
from ..serve import KVCompressionConfig, generate
from .mesh import cli_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mesh", default="", help="data x model, e.g. 1x2 (default: the world x 1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-compress", type=int, default=0, metavar="RANK",
                    help="compress full-attention KV caches at this rank "
                         "(decode-native streaming SVD; 0 = dense caches)")
    ap.add_argument("--kv-adaptive", action="store_true",
                    help="share the rank budget adaptively across heads")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    kc = None
    if args.kv_compress:
        kc = KVCompressionConfig(rank=args.kv_compress, oversample=2, panel=32,
                                 decode_panel=8, refresh_every=32,
                                 adaptive=args.kv_adaptive,
                                 min_rank=max(1, args.kv_compress // 4))

    dev = resolve_device(args.device)
    mesh = cli_mesh(args.mesh, dev, args.batch)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    mod = get_arch(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    params = init_params(generator(args.seed, dev), cfg, device=dev)
    say(f"[serve] {cfg.name}: {param_count(params) / 1e6:.2f}M params on {dev}, mesh "
        f"{mesh.shape['data']}x{mesh.shape['model']}")
    shard_params(params, ParallelismRules(), mesh)

    gen = generator(args.seed + 1, dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                           device=dev)
    vision = synth_patch_embeddings(gen, cfg, args.batch, dev) if cfg.d_vision else None
    prompt, vision = shard_batch(prompt, mesh), shard_batch(vision, mesh)
    timings, stats = {}, {}
    t0 = time.perf_counter()
    with activation_sharding(mesh):
        out = generate(params, cfg, prompt, args.gen, gen=gen, temperature=args.temperature,
                       vision=vision, dense_moe=True, kv_compress=kc, timings=timings,
                       stats=stats)
    dt = time.perf_counter() - t0
    n_tok = out.numel()
    mode = (f"compressed kv @ rank {kc.rank}" + (" adaptive" if kc.adaptive else "")
            if kc else "dense kv")
    say(f"[serve] generated {tuple(out.shape)} a rank in {dt:.2f}s ({n_tok / dt:.1f} tok/s a "
        f"rank, {mode}, {stats['route']} decode; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in timings.items()) + ")")
    say("[serve] sample (rank 0's rows):", out[:, :16].tolist())
    return out


if __name__ == "__main__":
    main()
