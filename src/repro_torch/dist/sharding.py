"""Sharding rules: the mapping from (config, mesh) to the dimensions each
tensor shards over, and the collectives of explicit tensor and data
parallelism over ``torch.distributed``.

Port of the JAX package's ``dist/sharding.py``. Mesh dimensions ``pod``,
``data`` and ``ring`` are batch (data-parallel) dimensions; ``model`` is
the tensor-parallel dimension of the model families (and the sample
dimension of the messaging ring). ``ShardingRules`` keeps the reference's
fields and its ``spec`` verbatim: a spec (``P``) is a tuple with one entry
per tensor dimension, each None, a dimension name or a tuple of names, and
an axis that does not divide its dimension is dropped.

The JAX package hands the specs to GSPMD, which places the collectives.
The port places them by hand on the rank's local shards, one process per
rank:

* ``local_shard`` slices a full tensor to this rank's part of a spec, and
  ``gather_shard`` (checkpoints, tests) is its inverse;
* a tensor-parallel region starts with ``copy_to_model`` (identity
  forward, all-reduce over ``model`` backward) on each replicated tensor
  that enters it, and ends with ``reduce_from_model`` (all-reduce forward,
  identity backward) on its partial output. Everything outside a region
  is replicated over ``model`` and computed alike on every model rank, so
  its gradients are whole there and need no sum;
* ``mean_over_batch`` is the mean over the batch dimensions of a value
  that every batch rank then uses alike (the loss, MoE's router
  statistics); its backward is the identity, and the trainer averages the
  gradients over the batch dimensions after the backward;
* ``gather_batch`` all-gathers this rank's rows over the batch dimensions
  (MoE's routing over the global batch without a model axis);
* serving (no autograd): ``gather_over_model`` all-gathers along a
  dimension, ``seq_slice`` is this rank's block of a split-KV cache's
  sequence axis (``cache_specs``: the sequence over ``model``),
  ``batch_rows`` shards a batch's rows or replicates them (``row_block``:
  this rank's rows), and ``gather_rows`` all-gathers the rows of several
  results over the batch dimensions as one packed buffer (the batched
  LiNGAM estimator's).

A dimension that the model ranks need not split evenly (attention
heads, the MLP's columns, the vocabulary) carries a ``Blocks`` entry in
its spec: the name ``model`` (equal to the plain name, so the specs equal
the reference's) with the count of units the dimension holds and their
width. The model ranks then hold balanced blocks of whole units, as
``numpy.array_split`` cuts them (``split_block``: the first ``count % M``
ranks one unit more, a block empty where ``count < M``), which is the
even cut wherever ``M`` divides ``count``. ``local_shard`` cuts such a
leaf, and ``gather_shard`` and ``gather_over_model(count=)`` gather
blocks of unequal length in one ``all_gather``: each block padded to the
largest, then trimmed.

A leaf whose sharded dimension concatenates equal parts that each split
by heads (Mamba2's ``w_zx``: z | x) is cut part by part: ``local_shard``
and ``gather_shard`` take ``parts``, and ``SPLIT_PARTS`` names those
leaves for every caller that shards or gathers a tree by its specs
(``shard_tree``, ``gather_tree``, the checkpoints).

FSDP (``rules.fsdp_axes`` set, as the reference's train cell sets it):
a training leaf is sharded over ``data`` as well, along the first
dimension its spec leaves whole and the data ranks divide
(``fsdp_specs``: the reference's ``zero1_specs`` with its default
``data_axes=("data",)``; a leaf no data size divides stays replicated over
``data``). Its float32 master shard enters the model as an ``FsdpShard``
(``trainer.loss_and_grads`` wraps it), and the model gathers it where the
layer that reads it runs (``gather_at_use``): the shard is cast to the
compute dtype and all-gathered over ``data``; the backward reduce-scatters
the gradient in float32 and hands this rank's slice to the master.

Context parallelism (``context_parallel=True, shard_heads=False``, the
reference's ``REPRO_OPT=cp_seq`` train and prefill cells): the model ranks
cut the sequence instead of the heads. Each model rank runs the contiguous
block ``seq_block`` of S/M positions of its batch rows, with every head,
every MLP column and the whole vocabulary for them. The parameters keep
their specs and shards; a layer gathers each leaf whose spec names
``model`` where it runs (``gather_at_use`` with the leaves' specs: one
``all_gather`` over ``model``, uneven ``Blocks`` padded and trimmed), and
the backward reduce-scatters its float32 gradient (the sum of the model
ranks' contributions, this rank's block of it). Attention all-gathers K
and V along the sequence (``gather_seq``, whose backward reduce-scatters
their gradients); MoE gathers the tokens the same way and reduce-scatters
its partial outputs (``scatter_seq``, whose backward all-gathers). Every
rank's loss is its block's mean, averaged over ``model`` as over the batch
ranks (``mean_over_model``), and ``average_over_batch_`` then sums what each
rank differentiated: a leaf whose spec names ``model`` arrives summed and
is divided by M, a leaf replicated over ``model`` is averaged over it.

The explicit path supports the reference's defaults under a model axis
(``shard_heads=True``, ``context_parallel=False``) and its context
parallelism (``context_parallel=True`` with ``shard_heads=False``), each
with or without FSDP: ``check_explicit`` refuses ``shard_heads=False``
alone and ``context_parallel=True`` with ``shard_heads=True``, which the
reference never builds. Collectives never run over a dimension of size 1.
``NO_SHARDING`` (no mesh) turns every helper into the identity, so the
same model code runs on one device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_flatten_with_names, tree_leaves, tree_map, tree_unflatten

#: The mesh dimensions a batch shards over, outermost first.
BATCH_DIMS = ("pod", "data", "ring")


class P(tuple):
    """A PartitionSpec: one entry per tensor dimension, each None, a mesh
    dimension name, or a tuple of names (the outer name first). A leaf of
    the port's trees (``utils.tree``), and equal to the plain tuple of its
    entries."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


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
    """Per-tensor-kind sharding for one (config, mesh) pair."""

    mesh: Any = None
    batch_axes: tuple = ()
    model_axis: str | None = None
    fsdp_axes: tuple = ()
    context_parallel: bool = False
    shard_heads: bool = True

    # -- axis sizes ---------------------------------------------------------

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

    # -- activation specs ---------------------------------------------------

    def spec(self, shape: tuple, kind: str) -> P:
        """The spec of an activation of ``shape`` and ``kind``.

        Kinds (see call sites in models/):
          act       (B, S, D)      residual stream
          ffn       (B, S, F)      gated-MLP hidden
          logits    (B, S, V)      unembedded logits
          heads     (B, S, H, dh)  post-RoPE q (and full-rank MLA q/k)
          kv_heads  (B, S, KV, dh) post-RoPE k/v
          mla_cache (B, S, r)      MLA latent cache rows
        Axes that do not divide the corresponding dim are dropped."""
        b = tuple(self.batch_axes) or None
        m = self.model_axis
        seq = m if self.context_parallel else None
        heads = m if (self.shard_heads and not self.context_parallel) else None
        table = {
            "act": (b, seq, None),
            "ffn": (b, seq, m if not self.context_parallel else None),
            "logits": (b, seq, m if not self.context_parallel else None),
            "heads": (b, seq, heads, None),
            "kv_heads": (b, seq, heads, None),
            "mla_cache": (b, seq, None),
        }
        parts = table.get(kind)
        if parts is None or len(parts) != len(shape):
            # Unknown kind / rank mismatch: constrain the batch dim only.
            parts = (b,) + (None,) * (len(shape) - 1)
        sizes = mesh_sizes(self.mesh)

        def ok(dim: int, axes) -> bool:
            if axes is None:
                return False
            names = axes if isinstance(axes, tuple) else (axes,)
            total = 1
            for a in names:
                total *= sizes.get(a, 1)
            return total > 1 and dim % total == 0

        return P(*[a if ok(d, a) else None for d, a in zip(shape, parts)])

    def act(self, x, kind: str):
        """The identity. The reference constrains a global array's layout
        here and lets GSPMD move the data; the port's model code already
        holds this rank's local shard of every activation, laid out as
        ``spec`` says, and places the collectives itself (the regions'
        ``copy_to_model``/``reduce_from_model``), so there is nothing to
        constrain."""
        return x


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
        batch_axes = tuple(a for a in BATCH_DIMS if sizes.get(a, 1) > 1)
    model_axis = "model" if sizes.get("model", 1) > 1 else None
    n_experts = getattr(cfg, "n_experts", 0) or 0
    if model_axis is not None and n_experts and n_experts % sizes["model"] != 0:
        model_axis = None
    return ShardingRules(mesh=mesh, batch_axes=tuple(batch_axes), model_axis=model_axis)


def check_explicit(rules: ShardingRules):
    """Refuse what the explicit path does not do: under a model axis the
    heads sharded without context parallelism (the reference's defaults),
    or the sequence sharded with the heads whole (``context_parallel=True,
    shard_heads=False``, its ``cp_seq``), each with or without FSDP
    (``fsdp_axes``)."""
    if rules.model_axis is None:
        return
    if rules.shard_heads == rules.context_parallel:
        raise NotImplementedError(
            "the explicit tensor-parallel path shards either the heads or the sequence over "
            f"the model dimension: shard_heads={rules.shard_heads}, "
            f"context_parallel={rules.context_parallel} are not supported")


def with_context_parallel(rules: ShardingRules) -> ShardingRules:
    """``rules`` with the reference's ``cp_seq`` pair
    (``launch/specs.py:72-82`` there): the sequence over the model ranks,
    the heads whole."""
    return replace(rules, context_parallel=True, shard_heads=False)


def context_parallel(rules: ShardingRules) -> bool:
    """Whether the model ranks cut the sequence (``context_parallel`` under
    a model axis)."""
    return rules.context_parallel and rules.model_axis is not None


def decode_rules(rules: ShardingRules) -> ShardingRules:
    """The rules a decode step runs under: tensor parallelism's where
    ``rules`` cut the sequence (the reference never sets ``cp_seq`` on a
    decode cell), ``rules`` themselves otherwise."""
    if not rules.context_parallel:
        return rules
    return replace(rules, context_parallel=False, shard_heads=True)


def local_rules(rules: ShardingRules) -> ShardingRules:
    """The rules a context-parallel rank runs the weight-parallel parts of
    a layer under, once its weights are gathered whole: no model axis (the
    batch axes as they are). ``rules`` themselves otherwise."""
    if not context_parallel(rules):
        return rules
    return replace(decode_rules(rules), model_axis=None)


def seq_block(s: int, rules: ShardingRules) -> tuple[int, int]:
    """``(lo, hi)``: this rank's block ``[r·S/M, (r+1)·S/M)`` of a sequence
    of ``s`` positions under context parallelism (all of it otherwise).
    Raises where the model ranks do not divide ``s`` (``make_cell``'s gate,
    as the reference's)."""
    if not context_parallel(rules):
        return 0, s
    m = rules.model_size
    if s % m:
        raise ValueError(f"a sequence of {s} positions does not split over {m} model ranks")
    r = model_index(rules)
    return r * (s // m), (r + 1) * (s // m)


# ---------------------------------------------------------------------------
# a rank's place on the mesh, and local shards of full tensors
# ---------------------------------------------------------------------------


def coordinate(rules: ShardingRules) -> dict:
    """This rank's index along each mesh dimension ({} without a mesh)."""
    if rules.mesh is None:
        return {}
    return dict(zip(rules.mesh.mesh_dim_names, rules.mesh.get_coordinate()))


def model_index(rules: ShardingRules) -> int:
    """This rank's index along the model dimension (0 without one)."""
    if rules.model_axis is None:
        return 0
    return coordinate(rules)[rules.model_axis]


def split_block(count: int, parts: int, index: int) -> tuple[int, int]:
    """``(lo, hi)``: block ``index`` of ``count`` units cut into ``parts``
    balanced blocks as ``numpy.array_split`` cuts them, the first ``count %
    parts`` blocks one unit longer (so block 0 is a largest one); equal
    blocks where ``parts`` divides ``count``, and empty ones past ``count``
    where ``count < parts``."""
    base, extra = divmod(count, parts)
    lo = index * base + min(index, extra)
    return lo, lo + base + (index < extra)


def block_sizes(count: int, parts: int) -> list[int]:
    """The length of each of ``split_block``'s blocks, in block order."""
    return [hi - lo for lo, hi in (split_block(count, parts, i) for i in range(parts))]


def model_block(count: int, rules: ShardingRules) -> tuple[int, int]:
    """This rank's ``split_block`` of ``count`` units over the model ranks
    (all of them without a model axis)."""
    return split_block(count, rules.model_size, model_index(rules))


class Blocks(str):
    """A spec entry: the mesh dimension ``name`` (a ``str`` equal to the
    plain name) over whose ranks a tensor dimension of ``count`` units of
    ``width`` entries each (attention heads of their head width, the
    MLP's columns or the vocabulary's rows of width 1) is cut into
    ``split_block``'s balanced blocks of whole units."""

    def __new__(cls, name: str, count: int, width: int = 1):
        entry = super().__new__(cls, name)
        entry.count, entry.width = count, width
        return entry

    def __reduce__(self):
        return Blocks, (str(self), self.count, self.width)

    def __repr__(self):
        return f"Blocks({str(self)!r}, {self.count}, {self.width})"


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _active(rules: ShardingRules, entry) -> tuple:
    """The names of a spec entry this rank's tensors are split over: mesh
    dimensions of size > 1, and ``model`` only when it is the rules' model
    axis (``make_rules`` drops it for a MoE config whose experts it does
    not divide: the weights are then whole on every rank)."""
    sizes = mesh_sizes(rules.mesh)
    return tuple(n for n in _names(entry)
                 if sizes.get(n, 1) > 1 and (n != "model" or rules.model_axis == n))


def shard_bounds(rules: ShardingRules, entry, size: int) -> tuple[int, int]:
    """(start, length) of this rank's block of a dimension of ``size``
    under a spec entry: block index the mixed-radix index over its names,
    the first name outermost; a ``Blocks`` entry's ``split_block`` of its
    units."""
    sizes, coord = mesh_sizes(rules.mesh), coordinate(rules)
    names = _active(rules, entry)
    if isinstance(entry, Blocks) and names:
        if size != entry.count * entry.width:
            raise ValueError(f"a dimension of {size} is not {entry!r}")
        lo, hi = split_block(entry.count, sizes[names[0]], coord[names[0]])
        return lo * entry.width, (hi - lo) * entry.width
    index, count = 0, 1
    for n in names:
        index, count = index * sizes[n] + coord[n], count * sizes[n]
    if size % count:
        raise ValueError(f"a dimension of {size} does not split over {count} shards ({entry})")
    return index * (size // count), size // count


#: Leaves (by their last key) whose sharded dimension concatenates equal
#: parts that each split by heads, and the number of parts: Mamba2's
#: ``w_zx`` is z | x along its columns, so a model rank holds its heads'
#: columns of z and of x (``param_specs`` keeps the reference's plain
#: ``P(None, "model")``, which GSPMD reshards and an even cut would get
#: wrong: z to rank 0, x to rank 1).
SPLIT_PARTS = {"w_zx": 2}


def split_parts(name: str) -> int:
    """The parts of the leaf named ``name`` (``utils.tree`` names, joined
    by ``/``): ``SPLIT_PARTS`` of its last key, else 1."""
    return SPLIT_PARTS.get(name.rsplit("/", 1)[-1], 1)


def local_shard(t: torch.Tensor, spec, rules: ShardingRules, parts: int = 1) -> torch.Tensor:
    """This rank's part of the full tensor ``t`` under ``spec``, as a tensor
    of its own (a copy when it is a part, so the full tensor can go). With
    ``parts`` > 1 each split dimension is ``parts`` equal blocks, each cut
    alike, and this rank's pieces of them are concatenated in order (a
    dimension split over ``model``; ZeRO-1's data slices are plain)."""
    out = t
    for dim, entry in enumerate(spec):
        names = _active(rules, entry)
        if names:
            k = parts if rules.model_axis in names else 1
            start, length = shard_bounds(rules, entry, t.shape[dim] // k)
            out = out.unflatten(dim, (k, -1)).narrow(dim + 1, start, length).flatten(dim, dim + 1)
    return out if out is t else out.clone(memory_format=torch.contiguous_format)


def _all_gather(t: torch.Tensor, dim: int, name: str, rules: ShardingRules,
                lengths: list | None = None) -> torch.Tensor:
    """The ranks' blocks of ``t`` along ``dim`` over the mesh dimension
    ``name``, concatenated in rank order: one ``all_gather``. With
    ``lengths`` (each rank's length along ``dim``) unequal blocks are
    padded to the largest first and trimmed after."""
    group = rules.mesh.get_group(name)
    top = max(lengths) if lengths else t.shape[dim]
    if top > t.shape[dim]:
        pad = list(t.shape)
        pad[dim] = top - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    if lengths and min(lengths) < top:
        parts = [p.narrow(dim, 0, n) for p, n in zip(parts, lengths)]
    return torch.cat(parts, dim)


def gather_shard(t: torch.Tensor, spec, rules: ShardingRules, parts: int = 1) -> torch.Tensor:
    """The full tensor from every rank's ``local_shard`` of it, with the
    same ``parts`` (a collective: every rank of the mesh calls it)."""
    for dim, entry in enumerate(spec):
        names = _active(rules, entry)
        if not names:
            continue
        if isinstance(entry, Blocks):
            m = mesh_sizes(rules.mesh)[names[0]]
            t = _all_gather(t, dim, names[0], rules,
                            [n * entry.width for n in block_sizes(entry.count, m)])
            continue
        t = t.unflatten(dim, (parts if rules.model_axis in names else 1, -1))
        for name in reversed(names):  # the innermost name first
            t = _all_gather(t, dim + 1, name, rules)
        t = t.flatten(dim, dim + 1)
    return t


def shard_tree(tree, specs, rules: ShardingRules):
    """``local_shard`` of every leaf of ``tree`` under its spec in
    ``specs`` (a tree of the same structure), split leaves by their parts;
    the tree itself without a mesh."""
    if rules.mesh is None:
        return tree
    return tree_unflatten(tree, [local_shard(t, s, rules, split_parts(name)) for (name, t), s in
                                 zip(tree_flatten_with_names(tree), tree_leaves(specs))])


def gather_tree(tree, specs, rules: ShardingRules) -> list:
    """The full leaves of a tree of this rank's shards, in ``tree_leaves``
    order (a collective)."""
    return [gather_shard(t, s, rules, split_parts(name)) for (name, t), s in
            zip(tree_flatten_with_names(tree), tree_leaves(specs))]


# ---------------------------------------------------------------------------
# the collectives of tensor and data parallelism
# ---------------------------------------------------------------------------


def _all_reduce(x: torch.Tensor, names: tuple, rules: ShardingRules, op=None) -> torch.Tensor:
    """``x`` (a fresh contiguous copy) reduced over the mesh dimensions
    ``names`` of size > 1, one after another."""
    x = x.clone(memory_format=torch.contiguous_format)
    for name in names:
        if mesh_sizes(rules.mesh).get(name, 1) > 1:
            dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=rules.mesh.get_group(name))
    return x


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``model``."""

    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules = rules
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, (ctx.rules.model_axis,), ctx.rules), None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over ``model`` forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, rules):
        return _all_reduce(x, (rules.model_axis,), rules)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOver(torch.autograd.Function):
    """Mean over the ranks of the mesh dimensions ``axes`` forward; the
    identity backward (each rank differentiates its own part, and the
    trainer averages the gradients)."""

    @staticmethod
    def forward(ctx, x, axes, rules):
        count = math.prod(mesh_sizes(rules.mesh).get(a, 1) for a in axes)
        return _all_reduce(x, axes, rules) / count

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherBatch(torch.autograd.Function):
    """All-gather of this rank's rows (dim 0) over the batch dimensions,
    in the order ``local_shard`` cuts them; the backward sums the gathered
    gradient over the batch dimensions and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, rules):
        ctx.rules = rules
        return gather_shard(x, P(tuple(rules.batch_axes)), rules)

    @staticmethod
    def backward(ctx, g):
        rules = ctx.rules
        g = _all_reduce(g, rules.batch_axes, rules)
        return local_shard(g, P(tuple(rules.batch_axes)), rules), None


def copy_to_model(x: torch.Tensor, rules: ShardingRules) -> torch.Tensor:
    """Enter a tensor-parallel region (the identity without a model axis)."""
    return x if rules.model_axis is None else _CopyToModel.apply(x, rules)


def reduce_from_model(x: torch.Tensor, rules: ShardingRules) -> torch.Tensor:
    """Leave a tensor-parallel region: the sum of the model ranks' partial
    outputs (the identity without a model axis)."""
    return x if rules.model_axis is None else _ReduceFromModel.apply(x, rules)


def max_over_model(x: torch.Tensor, rules: ShardingRules) -> torch.Tensor:
    """The elementwise max over the model ranks, outside autograd."""
    if rules.model_axis is None:
        return x
    return _all_reduce(x.detach(), (rules.model_axis,), rules, op=dist.ReduceOp.MAX)


def sum_over_model(x: torch.Tensor, rules: ShardingRules) -> torch.Tensor:
    """The sum over the model ranks, outside autograd."""
    if rules.model_axis is None:
        return x
    return _all_reduce(x.detach(), (rules.model_axis,), rules)


def gather_over_model(x: torch.Tensor, dim: int, rules: ShardingRules,
                      count: int | None = None) -> torch.Tensor:
    """The model ranks' blocks of ``x`` concatenated along ``dim`` in rank
    order, outside autograd (serving). With ``count`` the blocks are
    ``model_block``'s of ``count`` entries (heads, or the padded
    vocabulary's columns), uneven where the model ranks do not divide it;
    without, equal blocks."""
    if rules.model_axis is None:
        return x
    lengths = None if count is None else block_sizes(count, rules.model_size)
    return _all_gather(x.detach(), dim, rules.model_axis, rules, lengths)


def batch_rows(b: int, rules: ShardingRules) -> tuple[ShardingRules, P]:
    """The rules a batch of ``b`` rows runs under and the spec of its rows:
    the batch shards over the batch dimensions where ``b`` divides by
    their ranks, else it is replicated (``batch_axes=()``), as the
    reference's ``spec`` drops an axis that does not divide."""
    if b % rules.batch_shards:
        rules = replace(rules, batch_axes=())
    return rules, P(tuple(rules.batch_axes))


def row_block(b: int, rules: ShardingRules) -> tuple[ShardingRules, int, int]:
    """``batch_rows``' rules for a batch of ``b`` rows and this rank's rows
    ``[lo, hi)`` of it: its block over the batch dimensions, or all ``b``
    rows where they do not divide (every model rank the same rows)."""
    rules, spec = batch_rows(b, rules)
    lo, length = shard_bounds(rules, spec[0], b)
    return rules, lo, lo + length


def pack_rows(tensors) -> torch.Tensor:
    """Tensors with a common leading row count as one ``(rows, bytes)``
    uint8 tensor: each row holds the bytes of every tensor's row, in order."""
    rows = tensors[0].shape[0]
    return torch.cat([t.contiguous().reshape(rows, -1).view(torch.uint8) for t in tensors], 1)


def row_bytes(dtype, shape) -> int:
    """The bytes of one row of ``shape`` entries of ``dtype``."""
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def unpack_rows(buf: torch.Tensor, layout) -> list:
    """``pack_rows``' inverse: one tensor per ``(dtype, row_shape)`` of
    ``layout``, with the rows of ``buf``."""
    out, off = [], 0
    for dtype, shape in layout:
        width = row_bytes(dtype, shape)
        # A fresh row-major copy: a view of one row keeps the buffer's row
        # stride and offset, which a wider dtype (float64) cannot view.
        piece = buf[:, off:off + width].clone(memory_format=torch.contiguous_format).view(dtype)
        out.append(piece.reshape(buf.shape[0], *shape))
        off += width
    return out


def gather_rows(tensors, rules: ShardingRules) -> list:
    """Serving, outside autograd: every batch rank's rows of each tensor
    (this rank's among them, in ``local_shard``'s order), through one
    ``all_gather`` per batch dimension of one buffer that packs every
    tensor's rows (``pack_rows``). The tensors themselves where
    ``batch_shards == 1``."""
    tensors = [t.detach() for t in tensors]
    if rules.batch_shards == 1:
        return tensors
    full = gather_shard(pack_rows(tensors), P(tuple(rules.batch_axes)), rules)
    return unpack_rows(full, [(t.dtype, t.shape[1:]) for t in tensors])


def seq_slice(max_seq: int, rules: ShardingRules) -> tuple[int, int]:
    """``(start, length)`` of this rank's block of a split-KV cache's
    sequence axis of ``max_seq`` positions: blocks of ``L = ceil(max_seq /
    M)``, rank r owning positions ``[r L, min((r + 1) L, max_seq))``. Every
    rank's block holds L positions; the last rank's positions from
    ``max_seq`` on are never written and never read."""
    m = rules.model_size
    length = -(-max_seq // m)
    return model_index(rules) * length, length


def mean_over_batch(x: torch.Tensor, rules: ShardingRules) -> torch.Tensor:
    """The mean over the batch ranks (the identity without batch axes)."""
    if rules.batch_shards == 1:
        return x
    return _MeanOver.apply(x, tuple(rules.batch_axes), rules)


def mean_over_model(x: torch.Tensor, rules: ShardingRules) -> torch.Tensor:
    """The mean over the model ranks under context parallelism, where each
    holds its block's value (the loss); the identity backward, as
    ``mean_over_batch``'s. The identity otherwise."""
    if not context_parallel(rules):
        return x
    return _MeanOver.apply(x, (rules.model_axis,), rules)


def gather_batch(x: torch.Tensor, rules: ShardingRules) -> torch.Tensor:
    """Every batch rank's rows of ``x``, this rank's among them."""
    if rules.batch_shards == 1:
        return x
    return _GatherBatch.apply(x, rules)


#: Elements of one flat buffer that ``average_over_batch_`` all-reduces.
FLAT_NUMEL = 1 << 26


def _average_(tensors: list, axes: tuple, rules: ShardingRules):
    """Each tensor replaced by its mean over the ranks of the mesh
    dimensions ``axes``, in place, through all-reduces of flat float32
    buffers of at most ``FLAT_NUMEL`` elements (a larger tensor alone)."""
    sizes = mesh_sizes(rules.mesh)
    count = math.prod(sizes.get(a, 1) for a in axes)
    if count == 1:
        return
    i = 0
    while i < len(tensors):
        j, size = i, 0
        while j < len(tensors) and (j == i or size + tensors[j].numel() <= FLAT_NUMEL):
            size += tensors[j].numel()
            j += 1
        flat = torch.cat([t.reshape(-1).float() for t in tensors[i:j]])
        flat = _all_reduce(flat, axes, rules) / count
        for t, part in zip(tensors[i:j], flat.split([t.numel() for t in tensors[i:j]])):
            t.copy_(part.view_as(t))
        i = j


def average_over_batch_(tensors: list, rules: ShardingRules, specs=None):
    """Replace each gradient by its mean over the batch ranks, in place, in
    float32. With ``specs`` (the leaves' specs, in their order) an FSDP
    leaf's gradient is the sum over its data ranks already (the
    reduce-scatter of ``gather_at_use``'s backward): it is divided by
    their count and averaged over the other batch dimensions only (over
    none when the batch is replicated, ``batch_rows``, where every data
    rank summed the same gradient). Under context parallelism (``specs``
    required) the model ranks count as batch ranks: a leaf whose spec
    names ``model`` holds the sum over them already (the reduce-scatter
    of its gather at use, or MoE's experts, whose outputs every model
    rank's loss reads) and is divided by M; any other leaf is averaged
    over ``model`` too."""
    cp = context_parallel(rules)
    if cp and specs is None:
        raise ValueError("context parallelism averages the gradients by their specs")
    cuts = fsdp_cuts(specs, rules) if specs is not None else [None] * len(tensors)
    spec_list = tree_leaves(specs) if cp else [None] * len(tensors)
    sizes = mesh_sizes(rules.mesh)
    groups: dict = {}
    for t, cut, spec in zip(tensors, cuts, spec_list):
        names = _active(rules, cut[1]) if cut is not None else ()
        div = math.prod(sizes[n] for n in names)
        rest = tuple(a for a in rules.batch_axes if a not in names)
        if cp and spec_uses(spec, rules.model_axis):
            div *= rules.model_size
        elif cp:
            rest += (rules.model_axis,)
        if div > 1:
            t.div_(div)
        groups.setdefault(rest, []).append(t)
    for axes, group in groups.items():
        _average_(group, axes, rules)
    return tensors


# ---------------------------------------------------------------------------
# FSDP: training leaves sharded over the data ranks, gathered at use
# ---------------------------------------------------------------------------


def zero1_spec_for(shape, spec, data_axes: tuple[str, ...], axis_sizes: dict) -> P:
    """Add the data axes to the first unsharded, divisible dim of ``shape``."""
    data_size = math.prod(axis_sizes[a] for a in data_axes)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            used.add(a)
    if used & set(data_axes):
        return spec  # already data-sharded (e.g. FSDP applied upstream)
    for i, (dim, cur) in enumerate(zip(shape, entries)):
        if cur is None and dim % data_size == 0 and dim > 0:
            entries[i] = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
            return P(*entries)
    return spec  # nothing divisible: leave replicated


def zero1_specs(param_shapes, param_specs, mesh, data_axes=("data",)):
    """Moment-tensor specs with the extra data-parallel shard (ZeRO-1).
    ``param_shapes``' leaves are tensors or ``torch.Size``s."""
    axis_sizes = mesh_sizes(mesh)
    usable = tuple(a for a in data_axes if axis_sizes.get(a, 1) > 1)
    if not usable:
        return param_specs

    def one(shape_leaf, spec_leaf):
        return zero1_spec_for(getattr(shape_leaf, "shape", shape_leaf), spec_leaf, usable,
                              axis_sizes)

    return tree_map(one, param_shapes, param_specs)


def fsdp_specs(shapes, specs, rules: ShardingRules):
    """The FSDP specs of a tree of training leaves from their full (or
    model-sharded) ``shapes`` and their ``specs`` (``lm.param_specs``): the
    reference's ``zero1_specs(shapes, specs, mesh)`` with its default
    ``data_axes=("data",)`` (``launch/specs.py:92-110`` there), so that on
    a ``pod`` x ``data`` x ``model`` mesh the pods still replicate the
    leaves; a leaf that no data size divides stays replicated. ``specs``
    themselves where ``rules.fsdp_axes`` is empty."""
    if not rules.fsdp_axes:
        return specs
    return zero1_specs(shapes, specs, rules.mesh)


def with_fsdp(rules: ShardingRules) -> ShardingRules:
    """``rules`` with the reference's train-cell FSDP axes
    (``launch/specs.py:103-110`` there): the ``pod`` and ``data``
    dimensions of size > 1 (none without a mesh)."""
    sizes = mesh_sizes(rules.mesh)
    return replace(rules, fsdp_axes=tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1))


def fsdp_cut(spec, rules: ShardingRules):
    """``(dim, entry)``: the dimension of a leaf that ``spec`` cuts over
    the FSDP dimensions (``rules.fsdp_axes`` of size > 1) and its entry, or
    None for a leaf they do not cut."""
    if not rules.fsdp_axes or spec is None:
        return None
    for dim, entry in enumerate(spec):
        if set(_active(rules, entry)) & set(rules.fsdp_axes):
            return dim, entry
    return None


def fsdp_cuts(specs, rules: ShardingRules) -> list:
    """``fsdp_cut`` of each leaf spec of ``specs``, in ``tree_leaves``
    order."""
    return [fsdp_cut(s, rules) for s in tree_leaves(specs)]


class FsdpShard:
    """A training leaf's FSDP shard on its way into the model: the float32
    master ``shard`` (which autograd differentiates), the dimension
    ``dim`` and spec ``entry`` that cut it, and the ``dtype`` the model
    computes in (``trainer.loss_and_grads``' rule). ``gather_at_use``
    turns it into the full leaf where its layer runs."""

    __slots__ = ("shard", "dim", "entry", "dtype")

    def __init__(self, shard: torch.Tensor, dim: int, entry, dtype):
        self.shard, self.dim, self.entry, self.dtype = shard, dim, entry, dtype


def _reduce_scatter(g: torch.Tensor, dim: int, entry, rules: ShardingRules) -> torch.Tensor:
    """This rank's block of ``dim`` of the sum of ``g`` over the ranks of
    ``entry``'s dimensions, in ``local_shard``'s block order (the
    outermost name first), in float32."""
    for name in _active(rules, entry):
        group = rules.mesh.get_group(name)
        parts = [p.float().contiguous() for p in g.chunk(dist.get_world_size(group), dim)]
        g = torch.empty_like(parts[0])
        dist.reduce_scatter(g, parts, group=group)
    return g


class _GatherAtUse(torch.autograd.Function):
    """A leaf's FSDP shard cast to the compute dtype and all-gathered over
    its data dimensions along its cut, in ``local_shard``'s block order:
    the wire carries the compute dtype (bfloat16 under the cast), as the
    reference's constraint on its bfloat16 copy does. The backward takes
    the full gradient to float32 and reduce-scatters it over the same
    dimensions: this rank's slice of the sum over its data ranks, the
    master's gradient (the trainer divides it by their count). The sum is
    taken in float32, as ``average_over_batch_`` takes its mean, so it
    rounds as the path without FSDP does."""

    @staticmethod
    def forward(ctx, shard, dim, entry, dtype, rules):
        ctx.dim, ctx.entry, ctx.rules = dim, entry, rules
        t = shard.to(dtype)
        for name in reversed(_active(rules, entry)):  # the innermost name first
            t = _all_gather(t, dim, name, rules)
        return t

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.entry, ctx.rules), None, None, None, None


def gather_at_use(tree, rules: ShardingRules, specs=None):
    """``tree`` with each ``FsdpShard`` leaf gathered whole over its data
    dimensions, and under context parallelism each leaf whose spec in
    ``specs`` (a tree of ``tree``'s structure) names ``model`` gathered
    over ``model`` after that (``gather_model``): collectives on every rank
    of those dimensions, in the order the model reads its layers. The other
    leaves as they are; ``tree`` itself without FSDP or context
    parallelism."""
    cp = context_parallel(rules) and specs is not None
    if tree is None or not (rules.fsdp_axes or cp):
        return tree

    def one(x, spec=None):
        if isinstance(x, FsdpShard):
            x = _GatherAtUse.apply(x.shard, x.dim, x.entry, x.dtype, rules)
        return gather_model(x, spec, rules) if cp else x

    return tree_map(one, tree, specs) if cp else tree_map(one, tree)


# ---------------------------------------------------------------------------
# context parallelism: the sequence over the model ranks
# ---------------------------------------------------------------------------


def _reduce_scatter_dim(g: torch.Tensor, dim: int, name: str, rules: ShardingRules,
                        lengths: list | None = None, dtype=torch.float32) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``g`` over the ranks
    of the mesh dimension ``name``, summed in ``dtype``: blocks of
    ``lengths`` (each rank's, in rank order; padded to the largest and
    trimmed after), else equal ones. The blocks are stacked into one
    buffer, handed whole to ``reduce_scatter_tensor`` (a list of blocks
    would be copied into such a buffer by the backend, out of sight of
    the dry run's count of live bytes)."""
    group = rules.mesh.get_group(name)
    world = dist.get_world_size(group)
    parts = list(g.split(lengths, dim)) if lengths else list(g.chunk(world, dim))
    top = max(p.shape[dim] for p in parts)
    if any(p.shape[dim] < top for p in parts):
        pads = [list(p.shape) for p in parts]
        for shape in pads:
            shape[dim] = top - shape[dim]
        parts = [torch.cat([p, p.new_zeros(pad)], dim) if pad[dim] else p
                 for p, pad in zip(parts, pads)]
    stacked = g.new_empty((world, *parts[0].shape), dtype=dtype)
    for block, p in zip(stacked, parts):
        block.copy_(p)
    out = stacked.new_empty(stacked.shape[1:])
    dist.reduce_scatter_tensor(out.view(-1), stacked.view(-1), group=group)
    mine = lengths[coordinate(rules)[name]] if lengths else top
    return out if mine == top else out.narrow(dim, 0, mine)


class _GatherModel(torch.autograd.Function):
    """A leaf's model shard all-gathered whole along ``dim`` (blocks of
    ``lengths``, uneven ones padded and trimmed); the backward
    reduce-scatters the gradient in float32: the sum over the model ranks'
    uses, this rank's block."""

    @staticmethod
    def forward(ctx, shard, dim, lengths, rules):
        ctx.dim, ctx.lengths, ctx.rules = dim, lengths, rules
        return _all_gather(shard, dim, rules.model_axis, rules, lengths)

    @staticmethod
    def backward(ctx, g):
        r = ctx.rules
        return _reduce_scatter_dim(g, ctx.dim, r.model_axis, r, ctx.lengths), None, None, None


def gather_model(x: torch.Tensor, spec, rules: ShardingRules) -> torch.Tensor:
    """The whole leaf from this rank's shard ``x`` cut over ``model`` by
    ``spec`` (its ``Blocks`` entry's block sizes, or equal blocks), with
    autograd (``_GatherModel``); ``x`` itself where ``spec`` does not cut
    it over the model axis."""
    for dim, entry in enumerate(spec or ()):
        if rules.model_axis in _active(rules, entry):
            lengths = None
            if isinstance(entry, Blocks):
                lengths = [n * entry.width for n in block_sizes(entry.count, rules.model_size)]
            return _GatherModel.apply(x, dim, lengths, rules)
    return x


class _GatherSeq(torch.autograd.Function):
    """The model ranks' blocks of ``x`` along ``dim`` (the sequence)
    all-gathered in rank order; the backward reduce-scatters the gradient
    (the sum of every rank's, in float32), this rank's block in ``x``'s
    dtype."""

    @staticmethod
    def forward(ctx, x, dim, rules):
        ctx.dim, ctx.rules, ctx.dtype = dim, rules, x.dtype
        return _all_gather(x, dim, rules.model_axis, rules)

    @staticmethod
    def backward(ctx, g):
        r = ctx.rules
        return _reduce_scatter_dim(g, ctx.dim, r.model_axis, r).to(ctx.dtype), None, None


class _ScatterSeq(torch.autograd.Function):
    """The sum over the model ranks of ``x``, this rank's block along
    ``dim`` (the sequence), summed in ``x``'s dtype; the backward
    all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, dim, rules):
        ctx.dim, ctx.rules = dim, rules
        return _reduce_scatter_dim(x, dim, rules.model_axis, rules, dtype=x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.rules.model_axis, ctx.rules), None, None


def gather_seq(x: torch.Tensor, dim: int, rules: ShardingRules) -> torch.Tensor:
    """Every model rank's block of the sequence along ``dim``, in order (K,
    V, MLA's latent, MoE's tokens); the identity without context
    parallelism."""
    if not context_parallel(rules):
        return x
    return _GatherSeq.apply(x, dim, rules)


def scatter_seq(x: torch.Tensor, dim: int, rules: ShardingRules) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the model ranks'
    partial ``x`` over the whole sequence (MoE's output); the identity
    without context parallelism."""
    if not context_parallel(rules):
        return x
    return _ScatterSeq.apply(x, dim, rules)


def shard_axes(spec, rules: ShardingRules) -> tuple:
    """The mesh dimensions over which a leaf under ``spec`` is split into
    this rank's shard, those a sum over the whole leaf adds its shards'
    sums over: the data dimensions of its FSDP cut (``fsdp_cut``), then
    the model axis where the spec names it."""
    cut = fsdp_cut(spec, rules)
    names = _active(rules, cut[1]) if cut is not None else ()
    if rules.model_axis is not None and spec_uses(spec, rules.model_axis):
        names += (rules.model_axis,)
    return names


def sum_over(x: torch.Tensor, names: tuple, rules: ShardingRules) -> torch.Tensor:
    """``x`` summed over the ranks of the mesh dimensions ``names`` (a
    fresh copy, outside autograd; a collective on those ranks)."""
    return _all_reduce(x.detach(), names, rules)


def spec_uses(spec, name: str) -> bool:
    """Whether any entry of ``spec`` names ``name``."""
    return any(name in _names(e) for e in spec)
