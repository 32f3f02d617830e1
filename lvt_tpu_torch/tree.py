"""Minimal pytree helpers over NamedTuples of tensors (the port's state
containers), standing in for ``jax.tree.map`` and
``jax.tree_util.tree_flatten_with_path``."""

from __future__ import annotations

from typing import Any, Callable


def is_node(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf-wise over NamedTuples of the same structure."""
    if is_node(tree):
        return type(tree)(*(
            tree_map(fn, *children)
            for children in zip(tree, *rest)
        ))
    return fn(tree, *rest)


def flatten_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(".field.sub", leaf), ...] in field order — the same key strings
    ``jax.tree_util.keystr`` gives for the JAX package's NamedTuples."""
    if is_node(tree):
        out = []
        for name, child in zip(tree._fields, tree):
            out += flatten_with_path(child, f"{prefix}.{name}")
        return out
    return [(prefix, tree)]


def unflatten_like(tree, leaves: dict):
    """Rebuild ``tree``'s structure from a {path: leaf} dict."""
    def build(node, prefix):
        if is_node(node):
            return type(node)(*(
                build(child, f"{prefix}.{name}")
                for name, child in zip(node._fields, node)
            ))
        return leaves[prefix]

    return build(tree, "")


def leaves(tree) -> list:
    """The leaves of ``tree`` in field order (``flatten_with_path``'s)."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def from_leaves(tree, values):
    """``tree``'s structure with ``values`` (in field order) as its
    leaves."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)
