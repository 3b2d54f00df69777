"""Trees of tensors: the port's parameter, optimizer and training-state
trees nest dicts, lists, tuples and NamedTuples (``QTensor``,
``AdamWState``, ``TrainState``), where the reference uses JAX pytrees.

``map_with_path`` walks every tensor with its path (dict keys, list and
tuple indices and NamedTuple field names, as strings); ``leaves`` lists
them in that order; ``unflatten_like`` rebuilds a tree's structure from a
list of new leaves. ``is_leaf`` stops the walk at a subtree (a
``QTensor`` moment, as the reference's ``is_leaf``).

The port keeps a model's layers as a list of per-layer dicts where the
reference stacks each leaf over the layers on a leading axis;
``reference_rank`` gives a leaf the rank its reference twin has, which
the optimizer's rules read (a layer's norm scale is 2-D there: the
reference decays it, compresses its gradient and may store its moments in
Q8_0).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

Path = Tuple[str, ...]


#: the port's per-layer lists, which the reference stacks on a leading axis
LAYER_LISTS = (("enc_blocks",), ("dec_blocks",), ("stack", "blocks"))


def in_layer_list(path: Path) -> bool:
    return any(path[:len(pre)] == pre for pre in LAYER_LISTS)


def reference_rank(path: Path, leaf) -> int:
    """The rank of ``leaf`` (at ``path`` in a parameter tree) in the
    reference's layout: one more for a leaf of a layer list."""
    return leaf.ndim + int(in_layer_list(path))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_with_path(fn: Callable[[Path, Any], Any], tree, path: Path = (),
                  is_leaf: Optional[Callable[[Any], bool]] = None):
    """``fn(path, leaf)`` over every leaf of ``tree``, the structure
    kept."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),), is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, v, path + (f,), is_leaf)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),), is_leaf)
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None
           ) -> List[Any]:
    """Every leaf of ``tree`` in the order ``map_with_path`` walks."""
    out: List[Any] = []
    map_with_path(lambda p, x: out.append(x), tree, is_leaf=is_leaf)
    return out


def leaves_with_path(tree, is_leaf: Optional[Callable[[Any], bool]] = None
                     ) -> List[Tuple[Path, Any]]:
    out: List[Tuple[Path, Any]] = []
    map_with_path(lambda p, x: out.append((p, x)), tree, is_leaf=is_leaf)
    return out


def unflatten_like(tree, new_leaves: List[Any],
                   is_leaf: Optional[Callable[[Any], bool]] = None):
    """``tree``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it: Iterator[Any] = iter(new_leaves)
    out = map_with_path(lambda p, x: next(it), tree, is_leaf=is_leaf)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out
