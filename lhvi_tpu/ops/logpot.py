"""Batched leapfrog on (possibly tempered) NON-quadratic targets.

The continuous-part energy

    E(x) = β·[ x·h − ½ xJx + Σ_buckets Σ_f w_f · log φ_f(slots_f(x)) ]
           + (1−β)·[ −½ Σ_i (x_i − mid_i)² / s_i² ]

and its gradient come from ``CompiledFG.log_prob_cont_batched`` under
``jax.grad``; XLA fuses each bucket's gather and kernel math for the whole
chain batch. β (inverse temperature) and the diagonal base measure make the
same integrator serve plain HMC (β=1, no base) and annealed-SMC
rejuvenation (tempered target), mirroring ``engines.smc._base_log_prob`` up
to x-independent constants (which cancel in MH ratios).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def logpot_leapfrog(fg, x, p, xd, inv_mass, eps, n_steps: int,
                    beta=None, base_mid=None, base_inv_s2=None):
    """Batched merged half-kick leapfrog on a (possibly tempered)
    non-quadratic target.

    x, p: [C, n_cont]; xd: [C, n_disc] (held fixed); eps/beta traced ok.
    ``base_mid``/``base_inv_s2`` (both or neither) add the diagonal base
    measure of the tempered target. Returns ``(x1, p1, lp0, lp1)`` where
    lp = log-density of the tempered target at the start/end points, up
    to an x-independent constant.
    """

    def logp(X):
        lp = fg.log_prob_cont_batched(X, xd)
        if base_mid is not None:
            d = X - base_mid[None]
            lp = beta * lp - (1.0 - beta) * 0.5 * jnp.sum(
                d * d * base_inv_s2[None], axis=-1
            )
        return lp

    grad = jax.grad(lambda X: jnp.sum(logp(X)))
    e0 = logp(x)
    p = p + 0.5 * eps * grad(x)

    def body(i, carry):
        x, p = carry
        x = x + eps * inv_mass[None] * p
        g = grad(x)
        p = p + jnp.where(i == n_steps - 1, 0.5, 1.0) * eps * g
        return (x, p)

    x, p = jax.lax.fori_loop(0, n_steps, body, (x, p))
    return x, p, e0, logp(x)
