"""Frozen pytree dataclasses.

Subclassing `PyTreeNode` turns a class into a frozen dataclass registered
with `jax.tree_util.register_dataclass`, with a `.replace(**changes)`
method. A field declared with `field(pytree_node=False)` is static: it is
not a leaf, it is part of the tree structure (and so of jit's cache key),
and it must be hashable.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """dataclasses.field with a `pytree_node` flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


class PyTreeNode:
    """Base class: subclasses become frozen, registered pytree dataclasses."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
        meta = [f.name for f in fields
                if not f.metadata.get("pytree_node", True)]
        jax.tree_util.register_dataclass(cls, data_fields=data,
                                         meta_fields=meta)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
