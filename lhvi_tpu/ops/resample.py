"""Weight pipeline and systematic resampling for annealed SMC.

The per-temperature step runs a chain of small [N]-shaped ops between the
big state arrays: log-weight max, exp, normalize, ESS, cumulative sum.
XLA fuses the reductions and has a native cumsum, so this stays plain jnp;
on a sharded particle axis the reductions become psums over the mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def weight_pipeline(log_w: jax.Array):
    """(log_w unnormalized [N]) -> (lw_norm [N], cum [N], step_z, ess).

    ``cum`` is the inclusive cumulative of the normalized weights — feed it
    straight to ``searchsorted`` for systematic/multinomial resampling.
    """
    m = jnp.max(log_w)
    w = jnp.exp(log_w - m)
    s = jnp.sum(w)
    step_z = m + jnp.log(s)
    lwn = log_w - step_z
    wn = w / s
    ess = 1.0 / jnp.sum(wn * wn)
    return lwn, jnp.cumsum(wn), step_z, ess


def systematic_parents(key: jax.Array, cum: jax.Array, n: int) -> jax.Array:
    """Parent indices from a cumulative-weight vector (sorted positions →
    binary search; XLA lowers the search to vectorized gathers and, on a
    sharded particle axis, the downstream state gather to all-gather +
    permute collectives)."""
    u0 = jax.random.uniform(key, ())
    pos = (jnp.arange(n) + u0) / n
    return jnp.clip(jnp.searchsorted(cum, pos), 0, cum.shape[0] - 1).astype(
        jnp.int32
    )
