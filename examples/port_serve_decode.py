"""Serving on the PyTorch port: batched KV-cache decode of a reduced
architecture, the hybrid and SSM caches included (the port's version of
``examples/serve_decode.py``).

    PYTHONPATH=src python examples/port_serve_decode.py --arch jamba-v0.1-52b
        [--device cpu]

The prompt is stepped through the cache token by token (teacher forced),
then ``--max-new`` tokens are sampled at ``--temperature`` from a seeded
``torch.Generator``. An encoder-decoder (``--arch whisper-tiny``) encodes
random frames once and hands the encoder states to every step; the vlm
family decodes tokens only, as the reference's example. Runs on the card
unless ``--device cpu`` is given. Imports nothing of JAX or of the
``repro`` package.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import serve_inputs  # noqa: E402
from repro_torch.models import model as mm  # noqa: E402


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = mm.init_params(gen, cfg)
    total = args.prompt_len + args.max_new
    cache = mm.init_cache(cfg, args.batch, total, device=dev)
    req = serve_inputs(cfg, args.batch, args.prompt_len, gen)
    prompts, enc_out = req["tokens"], None
    if cfg.is_encoder_decoder:
        enc_out = mm.encode(params, cfg, req["frame_embeds"])

    logits = None
    sync(dev)
    t0 = time.perf_counter()
    for t in range(args.prompt_len):
        logits, cache = mm.decode_step(params, cfg, prompts[:, t:t + 1],
                                       cache, t, enc_out=enc_out)
    sync(dev)
    print(f"prefill (teacher-forced): {time.perf_counter() - t0:.2f}s")

    toks = []
    t0 = time.perf_counter()
    for t in range(args.prompt_len, total):
        probs = torch.softmax(logits[:, -1].float() / args.temperature, -1)
        nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        toks.append(nxt)
        logits, cache = mm.decode_step(params, cfg, nxt[:, None], cache, t,
                                       enc_out=enc_out)
    sync(dev)
    dt = time.perf_counter() - t0
    print(f"decoded {args.max_new} tokens x {args.batch} seqs in {dt:.2f}s "
          f"({args.max_new * args.batch / dt:.1f} tok/s on {dev.type})")
    out = torch.stack(toks, 1)
    print("sample ids:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
