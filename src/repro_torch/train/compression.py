"""Gradient compression for the data-parallel all-reduce.

Port of ``src/repro/train/compression.py`` over a ``torch.distributed``
process group in place of the reference's mesh axes. Two schemes:

* ``bf16``: each gradient is rounded to bfloat16 for the wire, then summed
  in float32 and divided by the group's size;
* ``int8``: per-tensor absmax int8 quantization with error feedback: the
  residual of the quantization is carried to the next call.

Both return gradients already averaged over the group, so they sit in
front of the optimizer where a plain mean would. Without an initialized
process group (or with a group of one rank) there is no collective, and
the result is the mean of one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_leaves, tree_unflatten


def _quantize_int8(x, scale_eps=1e-12):
    amax = torch.amax(torch.abs(x))
    scale = torch.clamp(amax, min=scale_eps) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _sum(x, group):
    if dist.is_available() and dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def compressed_psum_mean(grads, group=None, scheme: str = "bf16", error_state=None):
    """All-reduce-mean ``grads`` (a tree of this rank's gradients) over
    ``group`` (the default group when None) with wire compression.

    Returns (mean_grads, new_error_state); the error state is ``int8``'s
    residual tree (float32), passed back on the next call."""
    n = dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1
    flat = tree_leaves(grads)
    if scheme == "bf16":
        out = [(_sum(g.to(torch.bfloat16).float(), group) / n).to(g.dtype) for g in flat]
        return tree_unflatten(grads, out), error_state
    if scheme == "int8":
        errs = (tree_leaves(error_state) if error_state is not None
                else [torch.zeros_like(g, dtype=torch.float32) for g in flat])
        out, new_err = [], []
        for g, err in zip(flat, errs):
            corrected = g.float() + err
            q, scale = _quantize_int8(corrected)
            sent = q.float() * scale
            new_err.append(corrected - sent)
            out.append((_sum(sent, group) / n).to(g.dtype))
        return tree_unflatten(grads, out), tree_unflatten(grads, new_err)
    raise ValueError(f"unknown compression scheme {scheme!r}")
