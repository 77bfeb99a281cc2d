"""The collectives a rank issues, counted where it issues them.

Counterpart of ``src/repro/utils/hlo.py``. The JAX package hands its
layout to GSPMD and reads the collectives back out of the compiled HLO
text; the port places every collective by hand (``dist/sharding.py``,
``dist/ring.py``, ``dist/ring_order.py``, ``core/pairwise.py``,
``train/compression.py``), so it counts them at the call instead.

``CollectiveLedger`` is a context: while it is installed, each call of
``torch.distributed``'s collectives and point-to-point transfers (looked
up on the module, as every call site of the port looks them up) appends
one record in the reference's schema:

* ``op``: the reference's spelling (``all-reduce``, ``all-gather``,
  ``reduce-scatter``, ``all-to-all``; a receive, ``recv`` or an ``irecv``
  of ``batch_isend_irecv``, is one ``collective-permute``, as XLA's one
  op both sends and receives);
* ``out_bytes``: the bytes of the result on this rank (the gathered list,
  the scattered shard, the received buffer);
* ``operand_bytes`` and ``wire_bytes`` by the reference's conventions
  (``src/repro/utils/hlo.py:71-87``: an all-reduce's operand is its
  result and a ring moves 2 (g - 1) / g of it; an all-gather's operand is
  a g-th of its result; a reduce-scatter's operand is g times its result);
* ``group_size``: the ranks of the call's group (2 for a transfer).

A send (``send``, or an ``isend`` of ``batch_isend_irecv``) is the other
half of some rank's receive and adds no record. ``broadcast``,
``barrier`` and a bare ``isend``/``irecv`` outside ``batch_isend_irecv``
are not recorded: no code of the port issues them on a step (``isend``
and ``irecv`` stay unwrapped because ``batch_isend_irecv`` checks that
its ops are those very functions).

``summarize_collectives`` gives the reference's summary of the records,
verbatim. A subclass may override ``call`` to time each call
(``chip_smoke.py``'s ``CollectiveClock``).
"""

from __future__ import annotations

from collections import defaultdict

import torch.distributed as dist

#: The ``torch.distributed`` functions a ledger wraps, and the op each is.
WRAPPED = {
    "all_reduce": "all-reduce",
    "all_gather": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "recv": "collective-permute",
    "batch_isend_irecv": "collective-permute",
}


def nbytes(t) -> int:
    """A tensor's bytes (a list's, summed)."""
    if isinstance(t, (list, tuple)):
        return sum(nbytes(x) for x in t)
    return t.numel() * t.element_size()


def record(op: str, out_bytes: int, group_size: int) -> dict:
    """One record of ``op`` with a result of ``out_bytes`` on this rank over
    a group of ``group_size``: the reference's operand and wire bytes."""
    g = max(group_size, 1)
    if op == "all-reduce":
        operand, wire = out_bytes, 2 * out_bytes * (g - 1) / g
    elif op == "all-gather":
        operand, wire = out_bytes // g, out_bytes * (g - 1) / g
    elif op == "reduce-scatter":
        operand, wire = out_bytes * g, out_bytes * (g - 1)
    elif op == "all-to-all":
        operand, wire = out_bytes, out_bytes * (g - 1) / g
    elif op == "collective-permute":
        operand, wire = out_bytes, out_bytes
    else:
        raise ValueError(f"unknown collective {op!r}")
    return {"op": op, "out_bytes": int(out_bytes), "operand_bytes": int(operand),
            "wire_bytes": float(wire), "group_size": g}


#: Each collective's result argument (the first) by name, and the position
#: of its group argument.
_RESULT = {
    "all_reduce": ("tensor", 2),
    "all_gather": ("tensor_list", 2),
    "all_gather_into_tensor": ("output_tensor", 2),
    "reduce_scatter": ("output", 3),
    "reduce_scatter_tensor": ("output", 3),
    "all_to_all": ("output_tensor_list", 2),
    "all_to_all_single": ("output", 4),
}


def _arg(args, kwargs, i: int, name: str):
    return args[i] if len(args) > i else kwargs.get(name)


def records_of(name: str, args, kwargs) -> list[dict]:
    """The records of one call of ``torch.distributed.<name>``."""
    op = WRAPPED[name]
    if name == "batch_isend_irecv":
        return [record(op, nbytes(p.tensor), 2) for p in _arg(args, kwargs, 0, "p2p_op_list")
                if p.op is dist.irecv]
    if name == "send":
        return []
    if name == "recv":
        return [record(op, nbytes(_arg(args, kwargs, 0, "tensor")), 2)]
    result, at = _RESULT[name]
    group = _arg(args, kwargs, at, "group")
    return [record(op, nbytes(_arg(args, kwargs, 0, result)), dist.get_world_size(group))]


class CollectiveLedger:
    """Records every collective issued while installed (``with ledger:``),
    in ``records``. Not reentrant, and one at a time per process: it
    replaces module attributes of ``torch.distributed``."""

    def __init__(self):
        self.records: list[dict] = []
        self._saved: dict = {}

    def call(self, fn, args, kwargs):
        """Issue the wrapped call (a subclass times it here)."""
        return fn(*args, **kwargs)

    def _wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            self.records += records_of(name, args, kwargs)
            return self.call(fn, args, kwargs)

        wrapped.__wrapped__ = fn
        return wrapped

    def __enter__(self):
        if self._saved:
            raise RuntimeError("this CollectiveLedger is already installed")
        for name in WRAPPED:
            self._saved[name] = getattr(dist, name)
            setattr(dist, name, self._wrap(name, self._saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        self._saved = {}

    @property
    def calls(self) -> int:
        return len(self.records)


def summarize_collectives(records: list[dict]) -> dict:
    """The reference's summary: per op the count and the operand and wire
    bytes, and the totals."""
    agg = defaultdict(lambda: {"count": 0, "operand_bytes": 0, "wire_bytes": 0.0})
    for r in records:
        a = agg[r["op"]]
        a["count"] += 1
        a["operand_bytes"] += r["operand_bytes"]
        a["wire_bytes"] += r["wire_bytes"]
    total_operand = sum(a["operand_bytes"] for a in agg.values())
    total_wire = sum(a["wire_bytes"] for a in agg.values())
    return {
        "by_op": dict(agg),
        "total_operand_bytes": total_operand,
        "total_wire_bytes": total_wire,
    }
