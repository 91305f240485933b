"""Nested dicts, lists and tuples of tensors: the pytrees of the
optimizers and of the elastic trainer's grads (``jax.tree_util`` over
the same containers in the reference).  ``parallel.sharding.tree_map``
stays dict-only: its trees hold shapes and logical axes, tuples that are
leaves there."""

from typing import Any, Callable, List


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(
            tree_map(fn, *(t[i] for t in trees)) for i in range(len(first)))
    return fn(*trees)


def tree_leaves(tree) -> List[Any]:
    """The leaves in insertion order (dict keys as given)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def leaves_like(structure, tree) -> List[Any]:
    """``tree``'s subtrees at the leaf positions of ``structure``
    (``treedef.flatten_up_to``): a params tree's per-leaf state when
    the state's leaves are themselves lists."""
    if isinstance(structure, dict):
        return [x for k, v in structure.items()
                for x in leaves_like(v, tree[k])]
    if isinstance(structure, (list, tuple)):
        return [x for i, v in enumerate(structure)
                for x in leaves_like(v, tree[i])]
    return [tree]


def unflatten_like(structure, leaves):
    """A tree of ``structure``'s shape holding ``leaves`` in order."""
    return _build(structure, iter(leaves))


def _build(node, it):
    # a module-level recursion: a recursive closure would be a reference
    # cycle holding the leaves (gigabytes of host state) until the
    # collector runs
    if isinstance(node, dict):
        return {k: _build(v, it) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)
