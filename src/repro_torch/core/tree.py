"""Parameter and optimizer trees of the port: nested dicts and lists whose
leaves are tensors (``None`` an empty subtree), walked in one fixed order
-- dict keys sorted, as ``jax.tree_util`` walks a dict, list entries in
order.  The optimizer maps over them and the checkpoint manager names
their leaves by path."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def leaves_with_paths(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) of every leaf: a path is the dict keys and list indices
    from the root."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (i,))
    else:
        yield path, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """A tree shaped as ``like`` holding ``new_leaves`` in
    :func:`leaves_with_paths` order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (shaped as ``tree``), position by position."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])
