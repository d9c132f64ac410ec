"""Small tree utilities over the port's parameters (port of
``repro.common.tree``).

A tree is nested dicts and lists with tensors (or any other objects) as
leaves; the port's params are nested dicts plus the per-layer list
``params["layers"]``. A path is a tuple of dict keys (``str``) and list
indices (``int``), one element a level. ``flatten_dict`` joins a path
with ``sep`` into one string key and ``unflatten_dict`` inverts it: a
level whose keys are exactly ``"0" .. "n-1"`` was a list. An empty dict
is kept as a sentinel key, as the reference keeps it, so flatten and
unflatten stay a bijection (checkpoint structure checks compare flattened
keys).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

__all__ = [
    "EMPTY_SENTINEL",
    "tree_get",
    "tree_leaves",
    "tree_size",
    "tree_bytes",
    "tree_map_with_path",
    "flatten_dict",
    "unflatten_dict",
]

# path suffix marking an EMPTY dict subtree
EMPTY_SENTINEL = "__empty_dict__"

Path = Tuple[Any, ...]


def tree_map_with_path(fn: Callable[[Path, Any], Any], tree: Any) -> Any:
    """Map ``fn(path, leaf)`` over the leaves, keeping dicts and lists."""

    def _walk(path: Path, node: Any) -> Any:
        if isinstance(node, dict):
            return {k: _walk(path + (str(k),), v) for k, v in node.items()}
        if isinstance(node, list):
            return [_walk(path + (i,), v) for i, v in enumerate(node)]
        return fn(path, node)

    return _walk((), tree)


def tree_get(tree: Any, path: Path) -> Any:
    """The node at ``path`` (a :func:`tree_map_with_path` path)."""
    for k in path:
        tree = tree[k]
    return tree


def tree_leaves(tree: Any) -> list:
    """The leaves in path order (dict insertion order, list order)."""
    out: list = []
    tree_map_with_path(lambda _, leaf: out.append(leaf), tree)
    return out


def tree_size(tree: Any) -> int:
    """Total number of tensor elements in a tree."""
    return sum(x.numel() for x in tree_leaves(tree) if torch.is_tensor(x))


def tree_bytes(tree: Any) -> int:
    """Total bytes of the tensors in a tree."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if torch.is_tensor(x))


def flatten_dict(tree: Any, sep: str = "/") -> Dict[str, Any]:
    """Flatten a tree into ``{"a/0/b": leaf}`` (see the module doc)."""
    out: Dict[str, Any] = {}

    def _key(prefix: str, name: str) -> str:
        return f"{prefix}{sep}{name}" if prefix else name

    def _walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict) and not node:
            out[_key(prefix, EMPTY_SENTINEL)] = torch.zeros((0,))
        elif isinstance(node, dict):
            for k, v in node.items():
                _walk(_key(prefix, str(k)), v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                _walk(_key(prefix, str(i)), v)
        else:
            out[prefix] = node

    _walk("", tree)
    return out


def unflatten_dict(flat: Dict[str, Any], sep: str = "/") -> Any:
    """Inverse of :func:`flatten_dict`."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        keys = path.split(sep)
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if keys[-1] == EMPTY_SENTINEL:
            continue               # the key's presence made the empty dict
        node[keys[-1]] = leaf

    def _fix(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        node = {k: _fix(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return _fix(root)
