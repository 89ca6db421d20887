"""Minor-axis value selection as an unrolled compare-select.

``take_along_axis`` over a small trailing value axis is the idiom behind
every discrete slot-value lookup in this framework. :func:`select_last`
computes the same result with V fused elementwise selects and no
materialized broadcast of the value table. It was written against a slow
gather lowering on another accelerator; whether plain ``take_along_axis``
is as fast on the GPU is open (ROADMAP design item 5).
"""

from __future__ import annotations

import jax.numpy as jnp


def select_last(vals, idx, max_unroll: int = 32):
    """``take_along_axis(vals, idx[..., None], -1)[..., 0]`` after NumPy
    broadcasting of ``vals[..., v]`` against ``idx`` — via an unrolled
    compare-select when the value axis is small (``V <= max_unroll``).

    ``vals``: [..., V] value tables (leading dims broadcastable against
    ``idx`` — pass them UNbroadcast, e.g. ``table[None]`` for a batch).
    ``idx``: integer indices in ``[0, V)``; out-of-range yields 0 (the
    callers' padding rows carry zero weight).
    """
    V = vals.shape[-1]
    if V > max_unroll:
        shape = jnp.broadcast_shapes(vals.shape[:-1], idx.shape)
        vals = jnp.broadcast_to(vals, shape + (V,))
        idx = jnp.broadcast_to(idx, shape)
        return jnp.take_along_axis(vals, idx[..., None], axis=-1)[..., 0]
    out = jnp.where(idx == 0, vals[..., 0], 0.0)
    for v in range(1, V):
        out = out + jnp.where(idx == v, vals[..., v], 0.0)
    return out
