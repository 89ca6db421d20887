"""``lhvi_tpu.utils.struct``: frozen pytree dataclasses."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lhvi_tpu.utils import struct


@struct.dataclass
class _Pair:
    a: jax.Array
    name: str = struct.field(pytree_node=False, default="x")
    b: object = None


@struct.dataclass
class _Cfg:
    steps: int = struct.field(pytree_node=False, default=3)
    scale: float = struct.field(pytree_node=False, default=2.0)


def test_leaves_and_static_fields():
    p = _Pair(a=jnp.ones(2), name="y", b=jnp.zeros(3))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert [l.shape for l in leaves] == [(2,), (3,)]
    q = jax.tree_util.tree_unflatten(treedef, leaves)
    assert q.name == "y"
    # static fields live in the treedef: a different value is a different
    # structure
    assert (jax.tree_util.tree_structure(p)
            != jax.tree_util.tree_structure(p.replace(name="z")))
    doubled = jax.tree_util.tree_map(lambda v: v * 2, p)
    np.testing.assert_array_equal(np.asarray(doubled.a), [2.0, 2.0])


def test_replace_and_frozen():
    c = _Cfg()
    d = c.replace(steps=5)
    assert (c.steps, d.steps, d.scale) == (3, 5, 2.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        c.steps = 4
    assert c == _Cfg() and hash(c) == hash(_Cfg())


def test_config_as_static_jit_argument():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.name)
        return p.a * 2

    np.testing.assert_array_equal(np.asarray(f(_Pair(a=jnp.ones(2)))),
                                  [2.0, 2.0])
    f(_Pair(a=jnp.zeros(2)))  # same static fields: no retrace
    assert traces == ["x"]

    g = jax.jit(lambda x, cfg: x * cfg.scale + cfg.steps,
                static_argnames="cfg")
    assert float(g(1.0, _Cfg())) == 5.0
    assert float(g(1.0, _Cfg(steps=1))) == 3.0
