"""Serving launcher (static-batch path of ``repro/launch/serve.py``):
initialise a model from a seed and decode a batch of random prompts::

    python -m repro_torch.launch.serve --arch llama3_2_1b \
        --batch 4 --prompt-len 512 --max-new 32
    python -m repro_torch.launch.serve --arch granite_moe_1b_a400m \
        --batch 4 --prompt-len 512 --max-new 32
    python -m repro_torch.launch.serve --arch rwkv6_7b \
        --batch 4 --prompt-len 512 --max-new 32
    python -m repro_torch.launch.serve --arch granite_moe_1b_a400m --reduced --device cpu

Runs on the card by default; ``--device cpu --reduced`` is the CPU smoke run.
Prints prefill ms, decode ms per step and generated tokens per second, then
the launches of each kernel during ``generate`` (``[kernels]``; zero on the
CPU, where the plain twins run) and of each variant of the flash-attention
and grouped-matmul kernels (``[variants]``: FMA, tensor-core prefill and
decode tiles).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gmm
from repro_torch.kernels import wkv6 as wk
from repro_torch.models.api import build_model
from repro_torch.serve.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build_model(cfg, device=args.device)
    params = api.init(args.seed)
    gen = torch.Generator().manual_seed(args.seed)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(api.device)

    engine = ServeEngine(api, params, temperature=args.temperature, seed=args.seed)
    counters = {"flash_attention": fa.flash_attention, "gmm": moe_gmm.gmm, "wkv6": wk.wkv6}
    before = {name: fn.launches for name, fn in counters.items()}
    by_variant = {name: dict(fn.variant_launches) for name, fn in counters.items()
                  if hasattr(fn, "variant_launches")}
    res = engine.generate({"tokens": tokens}, max_new_tokens=args.max_new)
    launched = " ".join(f"{name}={fn.launches - before[name]}"
                        for name, fn in counters.items())
    variants = "; ".join(
        f"{name}: " + " ".join(f"{v}={n - by_variant[name][v]}"
                               for v, n in counters[name].variant_launches.items())
        for name in by_variant)
    toks = args.batch * args.max_new
    step_ms = res.decode_ms / max(res.decode_steps, 1)
    total_s = (res.prefill_ms + res.decode_ms) / 1e3
    print(f"[serve] {cfg.name} on {api.device}: batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new}  "
          f"prefill {res.prefill_ms:.3f} ms  decode {step_ms:.3f} ms/step  "
          f"{toks / total_s:.1f} tok/s")
    print("first sequence:", res.tokens[0].tolist())
    print(f"[kernels] {launched}")
    print(f"[variants] {variants}")
    return res


if __name__ == "__main__":
    main()
