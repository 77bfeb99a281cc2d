"""Trees of tensors: the port's parameters, optimizer state and caches are
nested dicts, lists and tuples with tensors at the leaves (``None`` is an
empty subtree, as in JAX).

Port of ``src/repro/utils/tree.py``. Dict keys are visited in sorted
order, as ``jax.tree_util`` visits them; a list or tuple's indices are
names, so ``tree_flatten_with_names`` gives ``groups/3/pos0/attn/wq``
where the JAX package, whose groups are stacked, gives
``groups/pos0/attn/wq``. ``stacked_ndims`` gives each leaf the rank it
has in the JAX package's stacked tree, for the rules that read a leaf's
rank there (weight decay and the bfloat16 compute cast on ``ndim >= 2``).

Only plain tuples are nodes: a subclass of ``tuple`` (a sharding spec,
``dist.sharding.P``, or a ``torch.Size``) is a leaf, so a tree of specs
maps leaf for leaf onto the tree of tensors it describes.
"""

from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_seq(tree) -> bool:
    return isinstance(tree, list) or type(tree) is tuple


def _is_node(tree) -> bool:
    return isinstance(tree, dict) or _is_seq(tree)


def tree_flatten_with_names(tree, prefix: str = ""):
    """Flatten a tree into ``(name, leaf)`` pairs, names joined by ``/``."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out += tree_flatten_with_names(child, f"{prefix}/{name}" if prefix else name)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_names(tree)]


def stacked_ndims(tree) -> list[int]:
    """Each leaf's rank in the JAX package's layout, in ``tree_leaves``
    order: its own ``ndim`` plus one for each list it sits in, since the
    port's lists (``groups``, ``enc_groups``) are the reference's stacked
    leading axis. A group's norm scale (d,) is (G, d) there."""

    def walk(t, depth):
        if t is None:
            return []
        if isinstance(t, dict):
            return [r for k in sorted(t) for r in walk(t[k], depth)]
        if _is_seq(t):
            inner = depth + isinstance(t, list)
            return [r for v in t for r in walk(v, inner)]
        return [t.ndim + depth]

    return walk(tree, 0)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure with ``leaves`` in the order of
    ``tree_leaves(like)``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if _is_seq(t):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(*args) for args in zip(tree_leaves(tree), *others)])


def param_count(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(leaf.numel() for leaf in tree_leaves(tree))


def param_bytes(tree) -> int:
    """Total bytes of a tree of tensors."""
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree))
