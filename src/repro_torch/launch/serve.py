"""Batched decode server loop (the port of ``repro.launch.serve``): prefill
a batch of prompts by stepping the KV cache, as the reference does, then
step it token by token, greedy at ``--temperature 0`` and sampled from a
``torch.Generator`` otherwise.

    python -m repro_torch.launch.serve --arch deepseek-moe-16b
    python -m repro_torch.launch.serve --arch mamba2-780m
    python -m repro_torch.launch.serve --arch deepseek-moe-16b --smoke --device cpu

Runs on the card unless ``--device cpu`` is given. Parameters and prompts
are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.launch.steps import build_decode_step
from repro_torch.models import model as model_mod


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(params, cfg, prompts, max_new: int, *, temperature: float = 0.0,
             gen=None):
    """prompts: [B, P] token ids on the parameters' device. Steps the cache
    through the P prompt tokens, then takes ``max_new`` tokens. Returns
    (tokens [B, max_new], {"prefill_s", "decode_s", "tok_per_s"}), the
    times on the host clock after a device synchronize."""
    b_, plen = prompts.shape
    dev = prompts.device
    decode = build_decode_step(cfg)
    cache = model_mod.init_cache(cfg, b_, plen + max_new, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(plen):
        logits, cache = decode(params, prompts[:, t:t + 1], cache, t)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    for t in range(plen, plen + max_new):
        last = logits[:, -1].float()
        if temperature == 0:
            nxt = torch.argmax(last, dim=-1)
        else:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        out.append(nxt)
        logits, cache = decode(params, nxt[:, None], cache, t)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return torch.stack(out, dim=1), {
        "prefill_s": prefill_s, "decode_s": decode_s,
        "tok_per_s": max_new * b_ / max(decode_s, 1e-9)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.config import reduced
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = model_mod.init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    tokens, st = generate(params, cfg, prompts, args.max_new,
                          temperature=args.temperature, gen=gen)
    print(f"prefill: {args.prompt_len} tokens in {st['prefill_s']:.2f}s; "
          f"decode: {args.max_new} tokens in {st['decode_s']:.2f}s "
          f"({st['tok_per_s']:.1f} tok/s)")
    print("generated token ids[0]:", tokens[0].tolist())
    return tokens, st


if __name__ == "__main__":
    main()
