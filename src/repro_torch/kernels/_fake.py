"""The kernel wrappers' branch for fake tensors.

A fake tensor (``torch._subclasses.fake_tensor.FakeTensor``, the dry
run's: ``launch/dryrun.py``) has a shape, a dtype and a device but no
memory, so a wrapper handed fake CUDA tensors cannot launch. It takes this
branch instead, a plain check before the launch: it allocates the outputs
the kernel would write, with their shapes, dtypes and aliasing, and notes
the call and its FLOPs (the wrapper module's ``flops``) with the recorder
the caller installed, if any. Nothing is launched, so the real launch
counts (``LAUNCHES`` and the like) do not move. A real tensor never takes
the branch.

A torch built without CUDA cannot run its C++ code (indexing,
``contiguous``, autograd) on fake CUDA tensors: it has no CUDA device
guard. There the dry run traces the card's path on fake CPU tensors inside
``stand_in()``, where a wrapper routes a fake CPU tensor as a fake CUDA
one.
"""

from __future__ import annotations

import contextlib
import contextvars

from torch._subclasses.fake_tensor import FakeTensor

_CALLS: contextvars.ContextVar = contextvars.ContextVar("fake_kernel_calls", default=None)
_STAND_IN: contextvars.ContextVar = contextvars.ContextVar("fake_cpu_stands_in", default=False)


def on_card(t) -> bool:
    """Whether ``t`` is a fake tensor on the card's route: on ``cuda``, or
    on the CPU inside ``stand_in()``."""
    if not isinstance(t, FakeTensor):
        return False
    return t.device.type == "cuda" or (t.device.type == "cpu" and _STAND_IN.get())


@contextlib.contextmanager
def stand_in():
    """Inside the block (this thread), fake CPU tensors take the card's
    route."""
    token = _STAND_IN.set(True)
    try:
        yield
    finally:
        _STAND_IN.reset(token)


def note(name: str, flops: float):
    """Record one fake call of the kernel ``name`` doing ``flops``."""
    calls = _CALLS.get()
    if calls is not None:
        calls.append((name, float(flops)))


@contextlib.contextmanager
def recording():
    """Collect the fake kernel calls of this thread inside the block: a list
    of ``(kernel name, flops)``."""
    calls: list = []
    token = _CALLS.set(calls)
    try:
        yield calls
    finally:
        _CALLS.reset(token)
