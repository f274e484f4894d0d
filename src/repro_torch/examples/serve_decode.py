"""Batched serving of a trained-from-scratch model with KV and recurrent
caches (port of the reference's ``examples/serve_decode.py``).

Prefill once, then decode greedily, for three architecture families: a
dense GQA decoder (granite-3-8b), a sliding-window one (h2o-danube-3-4b)
and the recurrent xLSTM (xlstm-1.3b), each at its smoke config, batch 2,
a 24-token prompt and 12 generated tokens.  Prefill runs attention through
the flash kernel K4 and the sLSTM scan through K5 (on the CPU the wrappers
take their plain versions).

  PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.common import paramdef as PD
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M

B, PROMPT, GEN = 2, 24, 12
ARCHS = ("granite-3-8b", "h2o-danube-3-4b", "xlstm-1.3b")


def generate(cfg, params, toks, gen: int):
    """Greedy decode of ``gen`` tokens after the prompt ``toks`` (B, P):
    the prefill's argmax, then ``gen - 1`` decode steps.  Returns (the
    tokens (B, gen), the logits of each decode step (B, gen - 1, V))."""
    Bn, P = toks.shape
    with torch.no_grad():
        logits, caches = M.prefill(params, cfg, {"tokens": toks})
        caches = M.grow_caches(cfg, caches, Bn, P + gen)
        tok = logits[:, -1].argmax(-1)[:, None]
        out, steps = [tok], []
        for i in range(gen - 1):
            lg, caches = M.decode_step(params, cfg, {"tokens": tok}, caches,
                                       P + i)
            tok = lg[:, 0].argmax(-1)[:, None]
            out.append(tok)
            steps.append(lg)
    return torch.cat(out, dim=1), torch.cat(steps, dim=1)


def main(device=None) -> dict:
    """Each architecture's generated tokens (B, GEN) on the CPU."""
    dev = resolve_device(device)
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  use_flash_kernel=True,
                                  use_slstm_kernel=True)
        params = PD.init_params(0, M.model_defs(cfg), dev,
                                draw_on_device=True)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (B, PROMPT))).to(dev)
        t0 = time.perf_counter()
        gen, _ = generate(cfg, params, toks, GEN)
        gen = gen.cpu()
        out[arch] = gen
        state_kind = "KV cache" if cfg.family == "dense" else \
            ("windowed KV" if cfg.window else "recurrent state")
        print(f"{arch:18s} [{state_kind:15s}] generated {gen.shape[1]} "
              f"tokens x {B} in {time.perf_counter() - t0:.1f}s -> "
              f"{gen[0][:8].tolist()}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
