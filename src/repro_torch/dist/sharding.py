"""Sharding rules: the mesh dimensions the batch and the samples shard over.

The port's part of the JAX package's ``dist/sharding.py``: the axis
assignment of ``ShardingRules`` and ``make_rules``, read from a mesh's
dimension sizes. Dimensions ``pod``, ``data`` and ``ring`` are batch
(data-parallel) dimensions; ``model`` is the tensor-parallel dimension of
the model families and the sample dimension of the messaging ring.

The rules' ``spec`` and ``act`` (the PartitionSpecs and activation
constraints of the model families' tensor parallelism) wait for the
first multi-card LM path (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


def mesh_sizes(mesh) -> dict:
    """Dimension name -> size of a ``DeviceMesh`` (its ``mesh_dim_names``
    and ``shape``), or of any object whose ``shape`` is such a mapping (a
    stub in the tests); ``{}`` for None."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


@dataclass(frozen=True)
class ShardingRules:
    """The batch and model dimensions of one (config, mesh) pair."""

    mesh: Any = None
    batch_axes: tuple = ()
    model_axis: str | None = None

    @property
    def model_size(self) -> int:
        if self.model_axis is None:
            return 1
        return mesh_sizes(self.mesh).get(self.model_axis, 1)

    @property
    def batch_shards(self) -> int:
        sizes = mesh_sizes(self.mesh)
        n = 1
        for a in self.batch_axes:
            n *= sizes.get(a, 1)
        return n


NO_SHARDING = ShardingRules()


def make_rules(cfg, mesh, batch_axes: tuple | None = None) -> ShardingRules:
    """Build the rules for ``cfg`` on ``mesh`` (dimensions ``pod``/``data``/
    ``ring``/``model``).

    * batch dimensions default to every present data-parallel dimension of
      size > 1, including the two-level ring's ``("pod", "ring", "model")``
      form, whose leading pod dimension stays an outer batch dimension;
      ``batch_axes=()`` replicates the batch.
    * ``model`` is the model dimension when present with size > 1, except
      for a mixture-of-experts config whose expert count it does not divide
      (expert parallelism needs ``n_experts % size == 0``)."""
    sizes = mesh_sizes(mesh)
    if batch_axes is None:
        batch_axes = tuple(a for a in ("pod", "data", "ring") if sizes.get(a, 1) > 1)
    model_axis = "model" if sizes.get("model", 1) > 1 else None
    n_experts = getattr(cfg, "n_experts", 0) or 0
    if model_axis is not None and n_experts and n_experts % sizes["model"] != 0:
        model_axis = None
    return ShardingRules(mesh=mesh, batch_axes=tuple(batch_axes), model_axis=model_axis)
