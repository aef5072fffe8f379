"""Parameter trees: nested dicts and lists with tensors at the leaves.

The port keeps the JAX package's parameter trees (``utils/weights.py``);
these helpers walk them in one fixed order, naming each leaf by its dotted
path (``blocks.3.s_attn.to_q.weight``), the key layout of the npz files.
"""

from __future__ import annotations

from typing import Callable, Iterator


def named_leaves(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """(dotted path, leaf) for every leaf, dict keys in insertion order."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from named_leaves(value, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from named_leaves(value, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def leaves(tree) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn: Callable, tree, *rest):
    """A tree of ``fn(leaf, *matching leaves of rest)``, same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree, prefix: str = ""):
    """A tree of ``fn(dotted path, leaf)``, same structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)
