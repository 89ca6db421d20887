"""Frozen pytree dataclasses (the subset of ``flax.struct`` this package uses).

``dataclass`` makes a frozen ``dataclasses.dataclass`` registered as a JAX
pytree: fields declared with ``field(pytree_node=False)`` are static (part
of the treedef, hashed by ``jit``), all others are leaves. Instances get a
``.replace(**changes)`` method.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A ``dataclasses.field``; ``pytree_node=False`` marks it static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["static"] = not pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree (``register_dataclass``)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    fields = [f for f in dataclasses.fields(cls) if f.init]
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
