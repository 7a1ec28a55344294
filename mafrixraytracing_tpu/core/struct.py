"""Frozen-dataclass pytrees.

`PyTreeNode` subclasses become frozen dataclasses registered with
`jax.tree_util.register_dataclass`: fields are pytree children unless
declared `field(pytree_node=False)`, in which case they are static
metadata (hashed into jit cache keys). `.replace(**changes)` returns a
modified copy.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """Dataclass field; `pytree_node=False` makes it static metadata."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


class PyTreeNode:
    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields
                         if f.metadata.get("pytree_node", True)],
            meta_fields=[f.name for f in fields
                         if not f.metadata.get("pytree_node", True)],
        )

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
