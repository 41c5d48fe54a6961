"""Trees of the port: nested dicts and lists whose leaves are tensors
(``None`` an empty subtree), walked in one fixed order -- dict keys
sorted, as ``jax.tree_util`` walks a dict, list entries in order.  A
``KVCache`` is a node of its ``k``, ``v`` and ``lengths``, and a
``QuantizedTensor`` one of its payload's parts in key order, as the JAX
package's pytrees flatten them.  The optimizer maps over the parameter
trees, the checkpoint manager names their leaves by path, and the
distribution layer lays out and gathers every tree a step touches."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

from repro_torch.core import attention_cache as AC
from repro_torch.core import formats as F

Path = Tuple[Any, ...]

_KV_FIELDS = ("k", "v", "lengths")


def leaves_with_paths(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) of every leaf: a path is the dict keys, list indices,
    cache fields and payload parts from the root."""
    if tree is None:
        return
    if isinstance(tree, AC.KVCache):
        for name in _KV_FIELDS:
            yield from leaves_with_paths(getattr(tree, name), path + (name,))
    elif isinstance(tree, F.QuantizedTensor):
        for k in sorted(tree.payload):
            yield from leaves_with_paths(tree.payload[k], path + (k,))
    elif isinstance(tree, dict):
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
    :func:`leaves_with_paths` order.  A rebuilt ``QuantizedTensor`` whose
    parts are tensors takes every dim but the last from them (the parts
    of every format share those with the values): a rank's rows, or its
    heads, of a quantized cache are a quantized cache of its rows or
    heads."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, AC.KVCache):
            k, v, lengths = (build(getattr(t, n)) for n in _KV_FIELDS)
            return AC.KVCache(k, v, lengths, t.fmt, t.v_width)
        if isinstance(t, F.QuantizedTensor):
            payload = {k: build(t.payload[k]) for k in sorted(t.payload)}
            part = next(iter(payload.values()))
            shape = tuple(t.shape)
            if hasattr(part, "shape") and len(part.shape) == len(shape):
                shape = tuple(part.shape[:-1]) + shape[-1:]
            return F.QuantizedTensor(t.fmt, shape, payload)
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
