"""Batched serving entry point (port of ``repro.launch.serve``): prefill a
prompt batch, then decode tokens autoregressively against per-layer
caches.

    python -m repro_torch.launch.serve --arch xlstm-1.3b --batch 4 \\
        --prompt-len 32 --gen 16
    python -m repro_torch.launch.serve --full --batch 4 --prompt-len 512 \\
        --gen 64                       # qwen3-1.7b at full width, bf16
    python -m repro_torch.launch.serve --device cpu     # smoke size here

It serves text only, as the reference's does: an audio or VLM arch is
served as text.  Random weights from ``--seed``, drawn on the device they
live on (seconds for billions of params on the card), a random prompt
from numpy's generator at the same seed (the reference's prompt).  Prefill
runs attention through the flash kernel (K4) and the sLSTM scan through
its kernel (K5); on the CPU both take their plain versions.  Then the
caches grow to the horizon (``prompt_len + gen``) and ``gen - 1`` decode
steps sample at ``--temperature`` from a ``torch.Generator`` seeded with
``--seed`` (the first token is the prefill's argmax, as in the reference).
Prints prefill seconds, decode tokens/s and the first sample ids, and
returns them with the allocator's peak on a card.  The clock is read only
after a synchronize.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.common import paramdef as PD
from repro_torch.common.device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import model as M


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, device=None) -> dict:
    """Serve one batch; ``device`` (or ``--device``) as
    ``resolve_device`` takes it.  Returns the run's numbers."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(device if device is not None else args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.modality != "text":
        cfg = dataclasses.replace(cfg, modality="text")  # text only
    cfg = dataclasses.replace(cfg, use_flash_kernel=True,
                              use_slstm_kernel=True)
    params = PD.init_params(args.seed, M.model_defs(cfg), dev,
                            draw_on_device=True)
    B, P, total = args.batch, args.prompt_len, args.prompt_len + args.gen
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))).to(dev)
    gen = torch.Generator(dev).manual_seed(args.seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    with torch.no_grad():
        # prefill, then pad the caches out to the generation horizon
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = M.prefill(params, cfg, {"tokens": prompt})
        caches = M.grow_caches(cfg, caches, B, total)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        print(f"prefill {P} tokens x {B}: {prefill_s:.2f}s", flush=True)

        tok = logits[:, -1].argmax(-1)[:, None]
        out = [tok]
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            logits, caches = M.decode_step(params, cfg, {"tokens": tok},
                                           caches, P + i)
            probs = torch.softmax(logits[:, 0].float() / args.temperature,
                                  dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
            out.append(tok)
        tokens = torch.cat(out, dim=1).cpu()
        _sync(dev)
        decode_s = time.perf_counter() - t0
    tok_s = args.gen * B / decode_s
    print(f"decoded {args.gen} tokens x {B} in {decode_s:.2f}s "
          f"({tok_s:.1f} tok/s)", flush=True)
    print("sample token ids:", tokens[0, :12].tolist(), flush=True)
    return {"arch": cfg.name, "dtype": cfg.dtype, "batch": B,
            "prompt_len": P, "gen": args.gen, "prefill_s": prefill_s,
            "decode_s": decode_s, "decode_steps": args.gen - 1,
            "tokens_per_s": tok_s, "tokens": tokens,
            "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None)}


if __name__ == "__main__":
    main()
