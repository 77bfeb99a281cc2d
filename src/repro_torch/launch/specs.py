"""Cell builders: (arch x shape x mesh) -> (step function, this rank's
arguments as fake tensors).

Counterpart of ``src/repro/launch/specs.py``. The reference builds
``ShapeDtypeStruct`` stand-ins and shardings for XLA to lower; the port has
no compiler between it and the card, so a cell holds the function a rank
runs and that rank's own arguments as fake tensors
(``torch._subclasses.fake_tensor``): shapes, dtypes and a device, no
memory. The dry run (``launch/dryrun.py``) runs the function once on them.

The three kinds are the reference's, each the port's own path:

* ``train``: ``trainer.make_train_step(..., accum_steps, param_specs,
  rules)`` over float32 masters with the bfloat16 compute copy, sharded as
  the reference's train cell shards them (``specs.py:92-110`` there):
  FSDP over the data dimensions of size > 1 (``rules.fsdp_axes``), each
  leaf cut over ``data`` by ``dist.sharding.fsdp_specs`` (the reference's
  ``zero1_specs``) as well as over ``model``, gathered where the model
  reads it; the parameters and ``optimizer.init_opt_state``'s moments
  stood up as those shards (an FSDP leaf's moments are its shard; ZeRO-1
  slices only a leaf that FSDP leaves whole);
* ``prefill``: ``lm.prefill(..., rules)``, the caches split-KV;
* ``decode``: ``lm.decode_step(..., rules)`` over ``lm.init_cache``'s
  caches cut to this rank by ``lm.local_caches`` (``lm.cache_specs``).

The batch shards over the batch ranks where its rows divide by them and is
replicated where they do not (``dist.sharding.batch_rows``: the reference's
``long_500k`` rule). ``REPRO_OPT`` is honoured as the reference honours it:
``kv_int8`` decodes over the int8 KV cache; ``cp_seq`` runs the train and
prefill cells of every family but ``ssm`` and ``hybrid`` under context
parallelism where the model ranks divide the sequence
(``context_parallel=True, shard_heads=False``: each model rank its block
of the positions with every head, the record's ``context_parallel`` true,
its ``head_block`` every head). The model ranks hold balanced blocks of the
attention heads, uneven where they do not divide them (yi-34b's 56, llama4's
40 and whisper's 8 heads over 16 ranks: ``attention.head_block``), and the
record names the traced rank's block (``head_block``); a config whose SSM
heads they do not split evenly is refused as the real path refuses it
(``check_heads``).

The parameters are drawn on fake CPU tensors (``lm.init_params(...,
rules=)``: this rank's shards) and stood up on the cell's device as empty
fake tensors. ``device="cuda"`` is the card's path; a torch built without
CUDA traces it on fake CPU tensors standing for the card
(``kernels/_fake.stand_in``), since it cannot run C++ code on fake CUDA
tensors. ``device="cpu"`` is the plain path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.dist.sharding import (
    ShardingRules, batch_rows, check_explicit, context_parallel, local_rules, make_rules,
    with_context_parallel, with_fsdp)
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ArchConfig
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.trainer import make_train_step
from repro_torch.utils.tree import tree_map


class Unsupported(Exception):
    """A cell the port's explicit path refuses (its reason)."""


@dataclass
class Cell:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    fn: Callable
    args: tuple  # trees of this rank's fake tensors
    mode: FakeTensorMode  # the mode the arguments belong to
    rules: ShardingRules
    device: str  # the path traced: "cuda" (the card's) or "cpu"
    traced_on: str  # the fake tensors' device
    info: dict = field(default_factory=dict)


def trace_device(device: str) -> str:
    """The fake tensors' device for the path ``device``: the card's path
    on a torch built without CUDA is traced on the CPU (``stand_in``)."""
    if device == "cuda" and not torch.backends.cuda.is_built():
        return "cpu"
    return device


def param_shapes(cfg: ArchConfig, dtype, rules: ShardingRules, mode: FakeTensorMode,
                 device: str = "cpu") -> Any:
    """This rank's parameters as fake tensors on ``device``:
    ``lm.init_params`` under ``mode`` (every leaf cut by ``lm.param_specs``
    to this rank's shard), stood up as empty tensors on ``device``."""
    with mode:
        params = lm.init_params(cfg, seed=0, dtype=dtype, device="cpu", rules=rules)
        return on_device(params, device)


def on_device(tree, device: str):
    """Empty fake tensors of ``tree``'s shapes and dtypes on ``device``
    (call under the tree's mode); the tree itself on the CPU."""
    if device == "cpu":
        return tree
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), tree)


def check_heads(cfg: ArchConfig, rules: ShardingRules):
    """Raise ``Unsupported`` where the model ranks of ``rules`` do not split
    ``cfg``'s heads as the real path needs: its SSM heads evenly, and
    sharded KV heads as their q heads, with the reason
    ``ssm.ssm_head_block`` and ``attention.head_blocks`` raise there. The
    attention's q heads split over any number of ranks. Under context
    parallelism every rank runs every head: nothing to split."""
    if rules.model_axis is None or context_parallel(rules):
        return
    try:
        if cfg.family != "ssm":
            attn.head_blocks(cfg, rules)
        if cfg.family in ("ssm", "hybrid"):
            ssm_mod.ssm_head_block(cfg, rules)
    except ValueError as e:
        raise Unsupported(str(e)) from None


def head_info(cfg: ArchConfig, rules: ShardingRules) -> dict:
    """The traced rank's block of the attention heads, ``[lo, hi)`` of
    ``n_heads`` (an SSM config's none; every head under context
    parallelism, which the record then states)."""
    if cfg.family == "ssm":
        return {}
    info = {"head_block": list(attn.head_block(cfg.n_heads, local_rules(rules))),
            "n_heads": cfg.n_heads}
    if context_parallel(rules):
        info["context_parallel"] = True
    return info


def make_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, opt_cfg: OptimizerConfig | None = None,
              accum_steps: int = 4, device: str = "cuda", max_seq: int | None = None,
              fsdp: bool = True) -> Cell:
    """The (``cfg``, ``shape``) cell of this process's rank of ``mesh``
    (a ``DeviceMesh`` over the process group, ``launch.mesh.fake_world``'s
    in the dry run; None for one rank). A prefill grows its caches to
    ``max_seq`` (default the prompt's length), as a serving engine asks.
    ``fsdp=False`` builds a train cell on the plain specs with ZeRO-1
    moments, as ``launch.train`` trains. Raises ``Unsupported`` for what
    the explicit path refuses."""
    rules = make_rules(cfg, mesh) if mesh is not None else ShardingRules()
    b, s = shape.global_batch, shape.seq_len
    rules, _ = batch_rows(b, rules)
    opts = os.environ.get("REPRO_OPT", "")
    if ("cp_seq" in opts and shape.kind in ("train", "prefill")
            and cfg.family not in ("ssm", "hybrid") and s % max(rules.model_size, 1) == 0):
        rules = with_context_parallel(rules)
    if ("kv_int8" in opts and shape.kind == "decode" and not cfg.mla
            and cfg.family not in ("ssm",)):
        cfg = cfg.with_overrides(kv_quant="int8")
    try:
        check_explicit(rules)
    except NotImplementedError as e:
        raise Unsupported(str(e)) from None
    check_heads(cfg, rules)
    b_rank = b // rules.batch_shards
    dev = trace_device(device)
    mode = FakeTensorMode()
    name = f"{cfg.name}/{shape.name}"
    specs = lm.param_specs(cfg)
    common = dict(mode=mode, rules=rules, device=device, traced_on=dev,
                  info={"batch_rows_per_rank": b_rank, "model_axis": rules.model_axis,
                        **head_info(cfg, rules)})

    if shape.kind == "train":
        if fsdp:
            rules = with_fsdp(rules)
        common["rules"] = rules
        specs = lm.param_specs(cfg, rules)
        params = param_shapes(cfg, torch.float32, rules, mode, dev)
        with mode:
            opt_state = init_opt_state(params, specs, rules)
            batch = {"tokens": torch.zeros((b_rank, s + 1), dtype=torch.int64, device=dev)}
            if cfg.enc_dec:
                batch["enc"] = torch.zeros((b_rank, cfg.enc_len, cfg.d_model), device=dev)
        step = make_train_step(lambda p, bt: lm.train_loss(p, bt, cfg, rules),
                               opt_cfg or OptimizerConfig(), accum_steps=accum_steps,
                               param_specs=specs, rules=rules)
        return Cell(name, "train", step, (params, opt_state, batch), **common)

    dtype = lm._DTYPES[cfg.dtype]
    params = param_shapes(cfg, dtype, rules, mode, dev)
    if shape.kind == "prefill":
        with mode:
            args = [params, torch.zeros((b_rank, s), dtype=torch.int64, device=dev)]
            if cfg.enc_dec:
                args.append(torch.zeros((b_rank, cfg.enc_len, cfg.d_model), dtype=dtype,
                                        device=dev))

        @torch.no_grad()
        def prefill(params, tokens, enc=None):
            return lm.prefill(params, tokens, cfg, rules, max_seq=max_seq, enc_in=enc)

        return Cell(name, "prefill", prefill, tuple(args), **common)

    if shape.kind == "decode":
        with mode:
            full = lm.init_cache(cfg, b, s, dtype, device="cpu")
            caches = on_device(lm.local_caches(full, cfg, rules), dev)
            token = torch.zeros((b_rank,), dtype=torch.int64, device=dev)
            pos = torch.zeros((b_rank,), dtype=torch.int64, device=dev)

        @torch.no_grad()
        def decode(params, token, caches, pos):
            return lm.decode_step(params, token, caches, pos, cfg, rules)

        return Cell(name, "decode", decode, (params, token, caches, pos), **common)

    raise ValueError(shape.kind)
