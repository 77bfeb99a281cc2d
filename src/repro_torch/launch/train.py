"""End-to-end training from the command line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --preset smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --model-shards 2 [--data-shards 1] [--device cpu]

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
loss_first10=... loss_last10=...`` line.

``--data-shards D --model-shards M`` (the reference's) train over D × M
ranks, one process per rank, on a ``(data, model)`` mesh
(``make_local_mesh``) with the reference's ``make_rules``: tensor (and
expert) parallelism over ``model``, data parallelism with ZeRO-1 over
``data``. The process group comes from the ``torchrun`` environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``):
``nccl`` on the card, one card per local rank, and ``gloo`` with
``--device cpu``; a caller may set up the group itself first. A world
size other than D × M is refused. The global batch is the reference's and
each data rank takes its rows (a batch that D does not divide stays
replicated, as ``spec`` drops a non-dividing axis). Every rank draws the
full weights from the one seed a layer at a time and keeps its shard.
Rank 0 alone prints ``train_done``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.paralingam import _device
from repro_torch.data.synthetic import TokenStream
from repro_torch.dist.sharding import NO_SHARDING, P, local_shard, make_rules
from repro_torch.launch.mesh import make_local_mesh
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


def parser() -> argparse.ArgumentParser:
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
    return ap


def _group(shards: int, dev: torch.device):
    """The process group of a sharded run: the caller's if it set one up,
    else one from the ``torchrun`` environment (``nccl`` on the card, each
    local rank on its own card; ``gloo`` on the CPU). Returns whether this
    call made it (and so destroys it)."""
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))
    if world != shards:
        raise SystemExit(f"--data-shards x --model-shards = {shards} ranks, but the world has "
                         f"{world}: start one process per rank (torchrun --nproc-per-node "
                         f"{shards})")
    if dist.is_initialized():
        return False
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl")
    return True


def run(args, hooks=None):
    """Train as ``args`` say (``hooks`` as ``trainer.train`` takes them).
    Returns (history, this rank's params, cfg, this rank's index in the
    world)."""
    shards = args.data_shards * args.model_shards
    dev = _device(args.device, "repro_torch.launch.train")
    cfg = preset_config(args.arch, args.preset)
    made = _group(shards, dev) if shards > 1 else False
    try:
        if shards > 1:
            mesh = make_local_mesh(args.data_shards, args.model_shards, device_type=dev.type)
            rules = make_rules(cfg, mesh, batch_axes=() if args.batch % args.data_shards else None)
            specs = lm.param_specs(cfg)
        else:
            rules, specs = NO_SHARDING, None
        params = lm.init_params(cfg, seed=args.seed, dtype=torch.float32, device=dev, rules=rules)
        log.info("arch=%s preset=%s params=%.1fM (this rank) device=%s rules=%s", cfg.name,
                 args.preset, param_count(params) / 1e6, dev, rules if shards > 1 else None)

        stream = TokenStream(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq, seed=args.seed)
        rows = P(tuple(rules.batch_axes))  # this rank's rows of the global batch

        def batch_fn(step):
            b = {"tokens": stream.tensor_batch_at(step, dev)}
            if cfg.enc_dec:
                b["enc"] = enc_frames(cfg, args.batch, args.seed, step, dev)
            return {k: local_shard(v, rows, rules) for k, v in b.items()}

        tcfg = TrainerConfig(
            total_steps=args.steps,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            log_every=10,
            opt=OptimizerConfig(lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps),
        )
        params, _, history = train(params, lambda p, b: lm.train_loss(p, b, cfg, rules), batch_fn,
                                   tcfg, hooks=hooks, param_specs=specs, rules=rules)
        return history, params, cfg, dist.get_rank() if shards > 1 else 0
    finally:
        if made:
            dist.destroy_process_group()


def main(argv=None):
    args = parser().parse_args(argv)
    history, _, cfg, rank = run(args)
    first = np.mean([h["loss"] for h in history[:10]]) if history else float("nan")
    last = np.mean([h["loss"] for h in history[-10:]]) if history else float("nan")
    log.info("loss first10=%.4f last10=%.4f", first, last)
    if rank == 0:
        print(f"train_done arch={cfg.name} steps={len(history)} "
              f"loss_first10={first:.4f} loss_last10={last:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
