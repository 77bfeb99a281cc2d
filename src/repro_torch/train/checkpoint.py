"""Atomic, asynchronous checkpoints of a tree of tensors.

Port of ``src/repro/train/checkpoint.py``. Layout::

    <dir>/step_<n>/       (written as step_<n>.tmp, then renamed: atomic)
        meta.json         {step, leaves: [{name, shape, dtype}]}
        <leaf-name>.npy   one file per leaf, named by tree_flatten_with_names

The contract of the trainer:

* the leaves are copied to the host before ``save`` returns (the trainer
  updates the parameters in place on its next step); the files are written
  on a background thread, so training is not blocked on the disk;
* a step's directory appears only at the atomic rename, so a preempted job
  never sees a torn checkpoint;
* ``latest_step`` / ``restore`` pick up the newest complete checkpoint:
  restarting after a failure is rerunning the same command;
* ``keep`` checkpoints are kept, the oldest removed.

numpy has no bfloat16, so a bfloat16 leaf is stored as its ``uint16`` bits
with ``"bfloat16"`` as its dtype in ``meta.json``; ``restore`` gives it
back bit for bit.

Checkpoints do not depend on the mesh, as in the reference. Sharded
(``specs``, a tree of ``dist.sharding.P`` of the tree's structure, and
``rules`` with a mesh: one process per rank), ``save`` gathers each full
leaf on every rank (a collective), rank 0 alone copies it to the host and
writes the files, and the handle's ``join`` holds every rank until the
write is done. ``restore`` reads the full leaves and keeps this rank's
shard of each, so a run restores on another mesh, or on one device. A
split leaf (``dist.sharding.SPLIT_PARTS``, by its name) is gathered and
cut part by part, so the files hold the one-rank layout. The
reference's ``shardings`` becomes ``device`` (and ``specs``/``rules``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.paralingam import _device
from repro_torch.dist.sharding import NO_SHARDING, gather_shard, local_shard, split_parts
from repro_torch.utils.log import get_logger
from repro_torch.utils.tree import tree_flatten_with_names, tree_leaves, tree_unflatten

log = get_logger("repro_torch.checkpoint")

_SAFE = re.compile(r"[^A-Za-z0-9_.-]")


def _fname(name: str) -> str:
    return _SAFE.sub("_", name)


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy, and the dtype name ``meta.json`` gives it."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class _Written:
    """The handle of a sharded save: ``join`` waits for rank 0's writer,
    then holds every rank of the mesh until it is done."""

    def __init__(self, thread):
        self.thread = thread

    def join(self):
        if self.thread is not None:
            self.thread.join()
        dist.barrier()


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3, block: bool = False, specs=None,
         rules=NO_SHARDING):
    """Write the checkpoint of ``step``. Returns a join()-able thread (a
    handle whose ``join`` every rank calls, when sharded)."""
    if rules.mesh is not None and specs is not None:
        named = tree_flatten_with_names(tree)
        full = [(name, gather_shard(leaf, spec, rules, split_parts(name)))
                for (name, leaf), spec in zip(named, tree_leaves(specs))]
        if dist.get_rank() != 0:
            handle = _Written(None)
            if block:
                handle.join()
            return handle
        handle = _Written(save(ckpt_dir, step, dict(full), keep=keep))
        if block:
            handle.join()
        return handle
    host = [(name, *_to_host(leaf)) for name, leaf in tree_flatten_with_names(tree)]

    def _write():
        t0 = time.time()
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        meta = {"step": step, "leaves": []}
        for name, arr, dtype in host:
            np.save(os.path.join(tmp, _fname(name) + ".npy"), arr)
            meta["leaves"].append({"name": name, "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)
        log.info("checkpoint step %d written in %.2fs", step, time.time() - t0)

    th = threading.Thread(target=_write, daemon=True)
    th.start()
    if block:
        th.join()
    return th


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "meta.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like, device=None, specs=None, rules=NO_SHARDING):
    """Load checkpoint ``step`` into the structure of ``like``, every leaf
    on ``device`` (the card unless ``device="cpu"``) in its stored dtype.
    With ``specs`` and a mesh, this rank's shard of each leaf (``like``
    holds the shards)."""
    dev = _device(device, "repro_torch.train.checkpoint.restore")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        dtypes = {leaf["name"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
    named = tree_flatten_with_names(like)
    spec_leaves = (tree_leaves(specs) if rules.mesh is not None and specs is not None
                   else [None] * len(named))
    leaves = []
    for (name, ref), spec in zip(named, spec_leaves):
        t = _from_host(np.load(os.path.join(path, _fname(name) + ".npy")), dtypes[name])
        if spec is not None:
            t = local_shard(t, spec, rules, split_parts(name))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: stored {tuple(t.shape)} (this rank's part), "
                             f"wanted {tuple(ref.shape)}")
        leaves.append(t.to(dev))
    return tree_unflatten(like, leaves)
