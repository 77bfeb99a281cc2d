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
back bit for bit. The reference's mesh-agnostic placement (``shardings``)
becomes ``device``: the port runs on one card.
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

from repro_torch.core.paralingam import _device
from repro_torch.utils.log import get_logger
from repro_torch.utils.tree import tree_flatten_with_names, tree_unflatten

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


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3, block: bool = False):
    """Write the checkpoint of ``step``. Returns a join()-able thread."""
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


def restore(ckpt_dir: str, step: int, like, device=None):
    """Load checkpoint ``step`` into the structure of ``like``, every leaf
    on ``device`` (the card unless ``device="cpu"``) in its stored dtype."""
    dev = _device(device, "repro_torch.train.checkpoint.restore")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        dtypes = {leaf["name"]: leaf["dtype"] for leaf in json.load(f)["leaves"]}
    leaves = []
    for name, ref in tree_flatten_with_names(like):
        arr = np.load(os.path.join(path, _fname(name) + ".npy"))
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: stored {arr.shape}, wanted {tuple(ref.shape)}")
        leaves.append(_from_host(arr, dtypes[name]).to(dev))
    return tree_unflatten(like, leaves)
