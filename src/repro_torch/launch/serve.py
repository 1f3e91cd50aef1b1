"""Batched serving driver: prefill + decode loop with timing (counterpart of
``repro/launch/serve.py``, with the reference's flags).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --smoke \\
      --batch 4 --prompt-len 64 --gen 32 --kv-compress 16

Runs on the card (``--device cpu`` runs on the CPU). MoE archs
(``--arch deepseek-v2-lite-16b``, ``kimi-k2-1t-a32b``) serve through the
dropless MoE path (``dense_moe=True``), as the reference CLI does.
A vision arch (``--arch llama-3.2-vision-90b``) gets synthetic patch
embeddings from the modality stub, passed to ``generate`` as ``vision``.
``--mesh`` takes only ``1x1``: the port serves on one card. ``--smoke`` is
the reference's flag as it is: ``store_true`` with ``default=True``, so the
command line always serves the arch's ``smoke_config()`` (``ROADMAP.md``
§3, behaviour of the reference).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_arch
from ..device import generator, resolve_device
from ..models import init_params, param_count
from ..models.modality import synth_patch_embeddings
from ..serve import KVCompressionConfig, generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mesh", default="1x1", help="data x model; the port takes only 1x1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-compress", type=int, default=0, metavar="RANK",
                    help="compress full-attention KV caches at this rank "
                         "(decode-native streaming SVD; 0 = dense caches)")
    ap.add_argument("--kv-adaptive", action="store_true",
                    help="share the rank budget adaptively across heads")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if tuple(int(x) for x in args.mesh.split("x")) != (1, 1):
        raise ValueError(f"--mesh {args.mesh}: the port serves on one card, only 1x1")
    kc = None
    if args.kv_compress:
        kc = KVCompressionConfig(rank=args.kv_compress, oversample=2, panel=32,
                                 decode_panel=8, refresh_every=32,
                                 adaptive=args.kv_adaptive,
                                 min_rank=max(1, args.kv_compress // 4))

    dev = resolve_device(args.device)
    mod = get_arch(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    params = init_params(generator(args.seed, dev), cfg, device=dev)
    print(f"[serve] {cfg.name}: {param_count(params) / 1e6:.2f}M params on {dev}")

    gen = generator(args.seed + 1, dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen,
                           device=dev)
    vision = synth_patch_embeddings(gen, cfg, args.batch, dev) if cfg.d_vision else None
    timings = {}
    t0 = time.perf_counter()
    out = generate(params, cfg, prompt, args.gen, gen=gen, temperature=args.temperature,
                   vision=vision, dense_moe=True, kv_compress=kc, timings=timings)
    dt = time.perf_counter() - t0
    n_tok = args.batch * args.gen
    mode = (f"compressed kv @ rank {kc.rank}" + (" adaptive" if kc.adaptive else "")
            if kc else "dense kv")
    print(f"[serve] generated {tuple(out.shape)} in {dt:.2f}s ({n_tok / dt:.1f} tok/s, {mode}; "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in timings.items()) + ")")
    print("[serve] sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
