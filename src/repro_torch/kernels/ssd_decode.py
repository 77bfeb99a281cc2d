"""Mamba2 SSD decode step: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``_ssd_decode_kernel`` of
``src/repro/kernels/ssd_decode.py`` through its entry ``ssd_decode``: per
token and head the SSM state (P, N) is decayed, rank-1 updated and
contracted with C,

    state' = state * exp(dt * A) + (dt * x) outer B
    y      = state' @ C + D * x

It is the inner update of every ``models.ssm.mamba2_decode``, so one decode
step of Mamba2-370M launches it once per layer (48 times). The kernel,
``csrc/ssd_decode.cu``, streams each (P, N) tile once, on a grid over
(batch row x head, 16-row slices of P), with 16-byte loads of
several state rows in flight per warp and a scalar path for rows that are
not 16-byte aligned; it is bound by memory, at a size where a launch's
fixed cost is of the same order (see the source).

The new state is a fresh buffer, not the old one updated in place: the
caller's cache stays valid and a step can be replayed from it, as with the
JAX package's immutable arrays.

On a CPU tensor :func:`ssd_decode` runs the plain version; on a CUDA tensor
it launches the kernel or raises; on a fake CUDA tensor (the dry run's) it
allocates what the launch writes and notes its ``flops``
(``kernels/_fake.py``).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import _fake

#: Kernel launches since the last reset, one per call on the card.
LAUNCHES = 0
_count_mu = threading.Lock()


def flops(b: int, h: int, p: int, n: int) -> float:
    """The FP32 operations of one launch on a (B, H, P, N) state, counted
    as the contraction y = state' @ C: a multiply and an add per state
    element, 2 P N per head and token."""
    return float(2 * b * h * p * n)


def ssd_decode_ref(state, x, dt, b, c, a, d):
    """Plain version, line for line the JAX package's ``ssd_decode_ref``
    (``src/repro/kernels/ssd_decode.py:93``)."""
    state = state.float()
    dt = dt.float()
    decay = torch.exp(dt * a[None, :])
    upd = torch.einsum("bhp,bn->bhpn", x.float() * dt[..., None], b.float())
    new_state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, c.float())
    y = y + x.float() * d[None, :, None]
    return y, new_state


def _check(state, x, dt, b, c, a, d):
    if state.ndim != 4 or min(state.shape) < 1:
        raise ValueError(f"state must be (B, H, P, N) with every size >= 1, got "
                         f"{tuple(state.shape)}")
    bsz, h, p, n = state.shape
    want = {"x": (bsz, h, p), "dt": (bsz, h), "b": (bsz, n), "c": (bsz, n),
            "a": (h,), "d": (h,)}
    for name, t in zip(want, (x, dt, b, c, a, d)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"want {name} {want[name]}, got {tuple(t.shape)}")
        if t.device != state.device:
            raise ValueError(f"{name} is on {t.device}, state on {state.device}")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_decode runs on cuda or cpu, not {state.device}")


@functools.cache
def _entry():
    from repro_torch.kernels import _build

    fn = _build.load("ssd_decode").ssd_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _outputs(state):
    """What a launch on the float32 (B, H, P, N) ``state`` writes: y (B, H,
    P) and a new state."""
    return (torch.empty(state.shape[:3], dtype=torch.float32, device=state.device),
            torch.empty_like(state))


def launch(state, x, dt, b, c, a, d):
    """The CUDA kernel on float32 contiguous CUDA tensors; returns
    ``(y, new_state)``. Counts nothing (see :func:`ssd_decode`)."""
    bsz, h, p, n = state.shape
    y, new_state = _outputs(state)
    rc = _entry()(state.data_ptr(), x.data_ptr(), dt.data_ptr(), b.data_ptr(),
                  c.data_ptr(), a.data_ptr(), d.data_ptr(), new_state.data_ptr(),
                  y.data_ptr(), bsz, h, p, n,
                  torch.cuda.current_stream(state.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_decode kernel launch failed with CUDA error {rc}")
    return y, new_state


def ssd_decode(state, x, dt, b, c, a, d):
    """Fused decode step.

    ``state: (B, H, P, N)``, ``x: (B, H, P)``, ``dt: (B, H)``, ``b, c: (B,
    N)``, ``a, d: (H,)``, any float type (computed in float32, as the TPU
    wrapper casts). Returns ``(y (B, H, P), new_state (B, H, P, N))``, both
    float32."""
    global LAUNCHES
    _check(state, x, dt, b, c, a, d)
    if state.device.type == "cpu" and not _fake.on_card(state):
        return ssd_decode_ref(state, x, dt, b, c, a.float(), d.float())
    args = [t.float().contiguous() for t in (state, x, dt, b, c, a, d)]
    if _fake.on_card(state):
        _fake.note("ssd_decode", flops(*state.shape))
        return _outputs(args[0])
    out = launch(*args)
    with _count_mu:
        LAUNCHES += 1
    return out
