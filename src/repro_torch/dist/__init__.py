"""Distributed layer: the sharding rules and the collectives of sharded
training (``sharding``: specs, local shards, the tensor-parallel regions,
the mean over the batch ranks), and the paper's messaging ring over
``torch.distributed`` (``ring``: the find-root; ``ring_order``: the full
ring-driven causal order), one process per rank.

Importing it needs no card and no process group. The JAX package's
``dist/compat.py`` (shims across JAX versions) has no counterpart.
"""

from repro_torch.dist.sharding import NO_SHARDING, P, ShardingRules, make_rules

__all__ = ["NO_SHARDING", "P", "ShardingRules", "make_rules"]
