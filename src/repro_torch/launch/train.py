"""End-to-end training from the command line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --preset smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

Port of ``src/repro/launch/train.py``. Presets: ``smoke`` (reduced
config), ``100m`` (~100M-parameter variant of the arch family), ``full``
(the published config). Runs on the card unless ``--device cpu``, and
raises without one. The weights are float32 masters drawn from a
``torch.Generator`` seeded with ``--seed`` on the device; the tokens come
from ``data.synthetic.TokenStream`` (seed ``--seed``), and for an
encoder-decoder model (whisper) the encoder's frame embeddings (B,
enc_len, d_model) are drawn with numpy from (``--seed``, the step). The
trainer casts the matrices to bfloat16 for the compute and keeps
``cfg.remat``. Prints the reference's ``train_done arch=... steps=...
loss_first10=... loss_last10=...`` line. ``--data-shards`` and
``--model-shards`` are the reference's; the port runs one card, and their
sharded path comes with ROADMAP.md queue 1 item 5.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.paralingam import _device
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import lm
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import TrainerConfig, train
from repro_torch.utils.log import get_logger
from repro_torch.utils.tree import param_count

log = get_logger("repro_torch.launch.train")


def preset_config(arch: str, preset: str):
    if preset == "full":
        return configs.get(arch)
    if preset == "smoke":
        return configs.smoke(arch)
    if preset == "100m":
        base = configs.smoke(arch)
        return base.with_overrides(
            n_layers=base.group_size * 8,
            d_model=512,
            n_heads=8,
            n_kv_heads=4,
            head_dim=64,
            d_ff=2048,
            d_ff_expert=min(512, base.d_ff_expert) if base.d_ff_expert else 0,
            vocab=8192,
            ssm_headdim=32 if base.family in ("ssm", "hybrid") else base.ssm_headdim,
        )
    raise ValueError(preset)


def enc_frames(cfg, batch: int, seed: int, step: int, device):
    """An encoder-decoder model's frame embeddings of one step, (batch,
    enc_len, d_model) float32 drawn with numpy from (seed, step)."""
    rng = np.random.default_rng((seed, step))
    x = rng.standard_normal((batch, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=configs.ARCH_NAMES)
    ap.add_argument("--preset", default="smoke", choices=("smoke", "100m", "full"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data-shards", type=int, default=1)
    ap.add_argument("--model-shards", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)

    if args.data_shards * args.model_shards != 1:
        raise SystemExit("the port trains on one device: --data-shards and --model-shards "
                         "wait for the sharding specs (ROADMAP.md queue 1 item 5)")
    dev = _device(args.device, "repro_torch.launch.train")
    cfg = preset_config(args.arch, args.preset)
    params = lm.init_params(cfg, seed=args.seed, dtype=torch.float32, device=dev)
    log.info("arch=%s preset=%s params=%.1fM device=%s", cfg.name, args.preset,
             param_count(params) / 1e6, dev)

    stream = TokenStream(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq, seed=args.seed)

    def batch_fn(step):
        b = {"tokens": stream.tensor_batch_at(step, dev)}
        if cfg.enc_dec:
            b["enc"] = enc_frames(cfg, args.batch, args.seed, step, dev)
        return b

    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        log_every=10,
        opt=OptimizerConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps),
    )
    _, _, history = train(params, lambda p, b: lm.train_loss(p, b, cfg), batch_fn, tcfg)

    first = np.mean([h["loss"] for h in history[:10]]) if history else float("nan")
    last = np.mean([h["loss"] for h in history[-10:]]) if history else float("nan")
    log.info("loss first10=%.4f last10=%.4f", first, last)
    print(f"train_done arch={cfg.name} steps={len(history)} "
          f"loss_first10={first:.4f} loss_last10={last:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
