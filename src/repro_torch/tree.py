"""Parameter and state trees: leaves in the reference's order, and its keys.

The reference's trees are nested dicts (and tuples) of arrays, flattened by
``jax.tree_util`` with every dict's keys sorted.  The port's are an
``nn.Module`` (its parameters named ``layers.mlp.w_up`` and so on), nested
dicts, flat dicts keyed by dotted names (optimizer state), tuples and
lists of these.  :func:`flatten` gives any of them as ``(path, leaf)``
pairs in the reference's order, a dict key with dots read as a nested
path, so each form of one tree flattens alike.

Key map, one to one: a port leaf named ``layers.mlp.w_up`` (path
``("layers", "mlp", "w_up")``) is the reference's leaf whose path prints
(``str(path)``) as :func:`ref_key` gives it,
``"(DictKey(key='layers'), DictKey(key='mlp'), DictKey(key='w_up'))"``,
and whose ``jax.tree_util.keystr`` is :func:`keystr`'s
``"['layers']['mlp']['w_up']"``; a tuple index ``i`` is ``SequenceKey(idx=i)``
and ``[i]``.
"""
from __future__ import annotations

from typing import Any, Union

from torch import nn

Path = tuple[Union[str, int], ...]


def _nest(mapping) -> dict:
    """A dict whose dotted string keys become nested dicts."""
    out: dict = {}
    for key, value in mapping.items():
        parts = key.split(".") if isinstance(key, str) else [key]
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def flatten(tree: Any) -> list[tuple[Path, Any]]:
    """``(path, leaf)`` pairs of ``tree`` in the reference's leaf order:
    dict keys sorted at each level, sequences in order; ``None`` holds no
    leaf; a module's leaves are its parameters."""
    out: list[tuple[Path, Any]] = []

    def walk(node, path: Path) -> None:
        if node is None:
            return
        if isinstance(node, nn.Module):
            node = dict(node.named_parameters())
        if isinstance(node, dict):
            nested = _nest(node)
            for k in sorted(nested):
                walk(nested[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def name(path: Path) -> str:
    """The port's dotted name of a leaf path."""
    return ".".join(str(p) for p in path)


def named_leaves(tree: Any) -> list[tuple[str, Any]]:
    """``(dotted name, leaf)`` pairs in the reference's order."""
    return [(name(p), x) for p, x in flatten(tree)]


def keystr(path: Union[Path, str]) -> str:
    """``jax.tree_util.keystr`` of the reference's leaf at ``path`` (or
    at a dotted name)."""
    if isinstance(path, str):
        path = tuple(path.split("."))
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in path)


def ref_key(path: Union[Path, str]) -> str:
    """``str(path)`` of the reference's leaf at ``path`` (or at a dotted
    name): the key its ``TieredAdamW`` files a leaf under."""
    if isinstance(path, str):
        path = tuple(path.split("."))
    keys = [f"SequenceKey(idx={p})" if isinstance(p, int)
            else f"DictKey(key={p!r})" for p in path]
    return "(" + ", ".join(keys) + ("," if len(keys) == 1 else "") + ")"
