"""Checkpoint and resume: the array leaves of a tree, written to and read from ``.npz``.

The counterpart of the JAX package's ``treekit.tree_serialise_leaves`` and
``tree_deserialise_leaves``, in the same file format and leaf order, so a
checkpoint written by either package loads in the other. A tree is made of
the port's dataclasses (their ``init`` fields, in declaration order, as an
equinox module's fields flatten), tuples, lists and dicts (by sorted key,
as ``jax.tree`` flattens them); tensors and numpy arrays are its array
leaves, anything else is static. A field that is not an ``init`` field
is derived state (``Mesh.bvh``'s cache) and is neither written nor read:
a loaded mesh builds its BVH again.

The rest of the JAX module (``Module``, ``field``, ``tree_at``,
``filter_jit``) has no counterpart: the port's frozen dataclasses and
``dataclasses.replace`` take its place.
"""

import dataclasses
import os
from collections.abc import Callable, Iterator
from typing import Any

import numpy as np
import torch


def _is_array(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _children(tree) -> list | None:
    """The subtrees of ``tree`` in flatten order, or None for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [getattr(tree, f.name) for f in dataclasses.fields(tree) if f.init]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    if isinstance(tree, dict):
        return [tree[key] for key in sorted(tree)]
    return None


def tree_leaves(tree, is_leaf: Callable[[Any], bool] = _is_array) -> list:
    """The leaves of ``tree`` that ``is_leaf`` picks (array leaves by default), in flatten order."""
    if is_leaf(tree):
        return [tree]
    children = _children(tree)
    return [] if children is None else [x for child in children for x in tree_leaves(child, is_leaf)]


def tree_rebuild(tree, new: Iterator, is_leaf: Callable[[Any], bool] = _is_array):
    """``tree`` with each leaf that ``is_leaf`` picks taken in flatten order from ``new``.

    A part whose leaves all come back as the same objects is kept as it
    was (a mesh with its cached BVH); any other part is rebuilt, a
    dataclass with :func:`dataclasses.replace`.
    """
    if is_leaf(tree):
        return next(new)
    children = _children(tree)
    if children is None:
        return tree
    items = [tree_rebuild(child, new, is_leaf) for child in children]
    if all(a is b for a, b in zip(items, children, strict=True)):
        return tree
    if isinstance(tree, dict):
        rebuilt = dict(zip(sorted(tree), items, strict=True))
        return {key: rebuilt[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    names = [f.name for f in dataclasses.fields(tree) if f.init]
    return dataclasses.replace(tree, **dict(zip(names, items, strict=True)))


def _npz_path(path) -> str:
    """``path`` with a ``.npz`` suffix: ``np.savez`` appends it, so the loader looks for the same name."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def tree_serialise_leaves(path, tree) -> None:
    """Save every array leaf of ``tree`` to ``path`` (``.npz``), as ``leaf_0``, ``leaf_1``... in flatten order.

    Static fields stay in code; restore with :func:`tree_deserialise_leaves`
    and a template of the same structure.

    >>> import tempfile, torch
    >>> tree = {"b": torch.ones(2), "a": (torch.arange(3), "static")}
    >>> with tempfile.TemporaryDirectory() as folder:
    ...     tree_serialise_leaves(f"{folder}/ckpt", tree)
    ...     like = {"b": torch.zeros(2), "a": (torch.zeros(3, dtype=torch.int64), "static")}
    ...     tree_deserialise_leaves(f"{folder}/ckpt", like)["a"][0]
    tensor([0, 1, 2])
    """
    leaves = [
        leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf
        for leaf in tree_leaves(tree)
    ]
    np.savez(_npz_path(path), **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})


def tree_deserialise_leaves(path, like):
    """Load the array leaves that :func:`tree_serialise_leaves` saved into the template ``like``.

    Each stored leaf must have its template leaf's shape (else
    ``ValueError("Shape mismatch ...")``); it takes that leaf's dtype and,
    for a tensor, its device. A checkpoint with more or fewer leaves than
    the template raises ``ValueError``.
    """
    with np.load(_npz_path(path)) as data:
        stored = [data[f"leaf_{i}"] for i in range(len(data.files))]
    template = tree_leaves(like)
    if len(stored) < len(template):
        msg = f"Checkpoint has {len(stored)} leaves, the template {len(template)}."
        raise ValueError(msg)
    if len(stored) > len(template):
        msg = f"Checkpoint has {len(stored) - len(template)} extra leaves for this template."
        raise ValueError(msg)
    loaded = []
    for value, leaf in zip(stored, template, strict=True):
        if tuple(value.shape) != tuple(leaf.shape):
            msg = (
                f"Shape mismatch deserialising leaf: stored {value.shape},"
                f" template {tuple(leaf.shape)}."
            )
            raise ValueError(msg)
        if isinstance(leaf, torch.Tensor):
            loaded.append(torch.from_numpy(value).to(device=leaf.device, dtype=leaf.dtype))
        else:
            loaded.append(np.asarray(value, dtype=leaf.dtype))
    return tree_rebuild(like, iter(loaded))
