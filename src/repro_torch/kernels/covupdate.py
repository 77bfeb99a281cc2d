"""Rank-1 iteration updates (paper Algorithms 7 and 8): the CUDA kernels'
wrappers and their plain versions.

Replace the TPU kernels ``_update_data_kernel`` and ``_update_cov_kernel``
of ``src/repro/kernels/covupdate.py`` through their entries ``update_data``
and ``update_cov``, for one dataset of any p and n (no padding copies):

    update_data: (x - b x_root) * rsqrt(max(1 - b^2, 1e-12)), row by row
    update_cov:  (c - b b^T) * inv inv^T, the unit diagonal restored

``b`` is the regression coefficient of every row on the root (``c[:,
root]``) with the root's own entry, and any dead row's, zeroed by the
caller. The kernels, ``csrc/covupdate.cu``, are single memory-bound passes.

These are not the updates ``fit`` runs: ``core.covariance.update_data`` and
``update_cov`` also clip b, floor 1 - b^2 at ``COLLINEAR_FLOOR`` and
renormalize the live rows, which the TPU kernels do not. As in the JAX
package, the kernels are reached through ``kernels.ops.update_data`` /
``update_cov`` only.

On a CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.core.covariance import VAR_EPS

#: Kernel launches since the last reset, one per call on the card.
DATA_LAUNCHES = 0
COV_LAUNCHES = 0
_count_mu = threading.Lock()


def _inv_scale(b):
    """1 / sqrt(max(1 - b^2, 1e-12)), as the kernels round it."""
    return 1.0 / torch.sqrt(torch.clamp(1.0 - b * b, min=VAR_EPS))


def update_data_ref(x, x_root, b):
    """Plain version of :func:`update_data`, in the TPU kernel's order of
    operations: ``(x - b x_root) * inv``."""
    return (x - b[:, None] * x_root[None, :]) * _inv_scale(b)[:, None]


def update_cov_ref(c, b):
    """Plain version of :func:`update_cov`: ``(c - b b^T) * inv_i * inv_j``,
    then exactly 1 on the diagonal."""
    inv = _inv_scale(b)
    new = (c - b[:, None] * b[None, :]) * inv[:, None] * inv[None, :]
    eye = torch.eye(c.shape[0], dtype=torch.bool, device=c.device)
    return torch.where(eye, 1.0, new)


def _check(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32 tensors, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if t.numel() < 1:
            raise ValueError(f"{name}: empty tensor {tuple(t.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")


@functools.cache
def _entries():
    from repro_torch.kernels import _build

    lib = _build.load("covupdate")
    data, cov = lib.update_data_launch, lib.update_cov_launch
    data.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    cov.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    data.restype = cov.restype = ctypes.c_int
    return data, cov


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def launch_data(x, x_root, b):
    """The update_data kernel on checked CUDA tensors. Counts nothing."""
    p, n = x.shape
    out = torch.empty_like(x)
    _raise_on(_entries()[0](x.data_ptr(), x_root.data_ptr(), b.data_ptr(), out.data_ptr(),
                            p, n, torch.cuda.current_stream(x.device).cuda_stream),
              "update_data")
    return out


def launch_cov(c, b):
    """The update_cov kernel on checked CUDA tensors. Counts nothing."""
    out = torch.empty_like(c)
    _raise_on(_entries()[1](c.data_ptr(), b.data_ptr(), out.data_ptr(), c.shape[0],
                            torch.cuda.current_stream(c.device).cuda_stream),
              "update_cov")
    return out


def update_data(x, x_root, b):
    """Algorithm 7 on one dataset: ``x: (p, n)`` normalized rows, ``x_root:
    (n,)`` the root's row, ``b: (p,)`` with ``b[root] = 0``. Returns the
    (p, n) refreshed rows."""
    global DATA_LAUNCHES
    _check("update_data", x, x_root, b)
    p, n = x.shape if x.ndim == 2 else (0, 0)
    if x.ndim != 2 or tuple(x_root.shape) != (n,) or tuple(b.shape) != (p,):
        raise ValueError(f"want x (p, n), x_root (n,), b (p,); got {tuple(x.shape)}, "
                         f"{tuple(x_root.shape)}, {tuple(b.shape)}")
    if x.device.type == "cpu":
        return update_data_ref(x, x_root, b)
    out = launch_data(x, x_root, b)
    with _count_mu:
        DATA_LAUNCHES += 1
    return out


def update_cov(c, b):
    """Algorithm 8 on one dataset: ``c: (p, p)`` correlations, ``b: (p,)``
    with ``b[root] = 0``. Returns the (p, p) refreshed correlations, unit
    diagonal."""
    global COV_LAUNCHES
    _check("update_cov", c, b)
    p = c.shape[0]
    if c.ndim != 2 or tuple(c.shape) != (p, p) or tuple(b.shape) != (p,):
        raise ValueError(f"want c (p, p), b (p,); got {tuple(c.shape)}, {tuple(b.shape)}")
    if c.device.type == "cpu":
        return update_cov_ref(c, b)
    out = launch_cov(c, b)
    with _count_mu:
        COV_LAUNCHES += 1
    return out
