"""Frozen dataclasses that are JAX pytrees (the state and train-state base).

Subclassing :class:`PyTreeNode` turns the class into a frozen dataclass
whose fields are pytree children, registered with
``jax.tree_util.register_dataclass``; ``.replace(**changes)`` returns a
copy with fields replaced.
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["PyTreeNode"]


class PyTreeNode:
    """Base class: every subclass is a frozen dataclass pytree."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        names = [f.name for f in dataclasses.fields(cls)]
        jax.tree_util.register_dataclass(cls, data_fields=names,
                                         meta_fields=[])

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)
