"""Parameter trees (nested dicts, and NamedTuples of them): the few
`jax.tree_util` operations the port needs. Dict leaves go in sorted key
order, the order JAX flattens a dict in."""
from __future__ import annotations


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of one or more trees with the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_unflatten(like, leaves: list):
    """`like`'s structure with `leaves` (in `tree_leaves` order) at its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a tree of NamedTuples (fields in order), dicts
    (sorted keys) and leaves, the path '/'-joined as the JAX package's
    checkpointer builds it ("opt/m/groups/sub0/mix/wq")."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    else:
        return [(prefix, tree)]
    return [pl for k, v in items
            for pl in tree_paths(v, f"{prefix}/{k}" if prefix else str(k))]


def state_leaves(tree) -> list:
    """The tensors of a state tree of NamedTuples (fields in order), tuples,
    lists and dicts (sorted keys), in `jax.tree_util.tree_leaves` order;
    None holds no leaf (an unquantized cache's scales, a cross slot)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in state_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in state_leaves(t)]
    return [tree]


def state_unflatten(like, leaves: list):
    """`like`'s structure (as `state_leaves` walks it) with `leaves` at its
    leaves."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
