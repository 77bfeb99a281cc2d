"""Batched LM serving from the command line.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --preset full --batch 4 --prompt-len 32 --new-tokens 16 [--device cpu]

Runs on the card unless ``--device cpu``. The weights are random, drawn from
a ``torch.Generator`` seeded with ``--seed`` on the device, in float32 (as
the JAX package's ``launch/serve.py`` builds them); the prompts are drawn with numpy
from the same seed, and for an encoder-decoder model (whisper) the encoder's
frame embeddings (B, enc_len, d_model) after them, as there. Prints the JAX package's ``serve_done ...`` line, the
wall time from the first prompt on the device to the last token read back
(the kernels' first-use build included, on the card).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch.train import preset_config
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=configs.ARCH_NAMES)
    ap.add_argument("--preset", default="smoke", choices=("smoke", "100m", "full"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)

    cfg = preset_config(args.arch, args.preset)
    params = lm.init_params(cfg, seed=args.seed, dtype=torch.float32, device=args.device)
    engine = Engine(params, cfg, ServeConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature), device=args.device)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    enc = None
    if cfg.enc_dec:
        enc = rng.standard_normal((args.batch, cfg.enc_len, cfg.d_model)).astype(np.float32)

    t0 = time.time()
    out = engine.generate(prompts, enc=enc, seed=args.seed)
    dt = time.time() - t0
    toks = out.size
    print(f"serve_done arch={cfg.name} batch={args.batch} "
          f"new_tokens={args.new_tokens} wall={dt:.2f}s "
          f"tok_per_s={toks/dt:.1f} device={engine.device}")
    print("sample:", out[0][:12].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
