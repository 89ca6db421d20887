"""Hybrid MAP inference by stochastic local search
(reference ``HybridMaxWalkSAT.py`` parity, SURVEY.md §3.1; mount empty —
behavioral reconstruction of MaxWalkSAT-style search over hybrid states).

Batched redesign: instead of one walker flipping one variable per step,
``n_walkers`` states run in lockstep under ``vmap``; each step every walker
either (greedy) applies the best single discrete reassignment — computed
from the same fused ``disc_logits`` pass chromatic Gibbs uses — plus a
gradient ascent move on all continuous vars, or (noise) a random
perturbation, MaxWalkSAT style. The best energy ever seen per walker is
tracked on-device; the global argmax is the MAP estimate.
"""

from __future__ import annotations

from functools import partial
import numpy as np
import jax
import jax.numpy as jnp
from lhvi_tpu.utils import struct

from lhvi_tpu.fg.compile import CompiledFG
from lhvi_tpu.ops.select import select_last

Array = jax.Array


@struct.dataclass
class MWSConfig:
    n_walkers: int = struct.field(pytree_node=False, default=64)
    n_steps: int = struct.field(pytree_node=False, default=300)
    p_random: float = struct.field(pytree_node=False, default=0.2)
    grad_step: float = struct.field(pytree_node=False, default=5e-2)
    n_grad: int = struct.field(pytree_node=False, default=3)
    noise_scale: float = struct.field(pytree_node=False, default=0.5)


@partial(jax.jit, static_argnames=("cfg",))
def run_mws(fg: CompiledFG, key: Array, cfg: MWSConfig = MWSConfig()):
    W = cfg.n_walkers
    k_init, k_run = jax.random.split(key)
    xc, xd = fg.init_state_batched(k_init, W, 1.0)

    grad_fn = jax.grad(fg.log_prob)

    def energy(xc, xd):
        return fg.log_prob(xc, xd)

    def walker_step(k, xc, xd):
        k_choice, k_var, k_val, k_noise = jax.random.split(k, 4)
        do_random = jax.random.uniform(k_choice, ()) < cfg.p_random

        # --- greedy branch -------------------------------------------------
        def greedy(xc, xd):
            if fg.n_disc:
                logits = fg.disc_logits(xc, xd)  # [n_disc, V]
                cur = select_last(logits, xd)
                gain = jnp.max(logits, axis=1) - cur
                v = jnp.argmax(gain)
                best_val = jnp.argmax(logits[v]).astype(jnp.int32)
                xd = xd.at[v].set(
                    jnp.where(gain[v] > 0, best_val, xd[v])
                )
            for _ in range(cfg.n_grad):
                g = grad_fn(xc, xd)
                g = jnp.nan_to_num(g)
                xc = jnp.clip(
                    xc + cfg.grad_step * g, fg.cont_lo, fg.cont_hi
                )
            return xc, xd

        # --- noise branch --------------------------------------------------
        def noisy(xc, xd):
            if fg.n_disc:
                v = jax.random.randint(k_var, (), 0, fg.n_disc)
                val = jax.random.randint(
                    k_val, (), 0, fg.disc_sizes[v]
                ).astype(jnp.int32)
                xd = xd.at[v].set(val)
            xc = jnp.clip(
                xc + cfg.noise_scale * jax.random.normal(k_noise, xc.shape),
                fg.cont_lo,
                fg.cont_hi,
            )
            return xc, xd

        return jax.lax.cond(do_random, noisy, greedy, xc, xd)

    def step(carry, k):
        xc, xd, best_e, best_xc, best_xd = carry
        keys = jax.random.split(k, W)
        xc, xd = jax.vmap(walker_step)(keys, xc, xd)
        e = jax.vmap(energy)(xc, xd)
        better = e > best_e
        best_e = jnp.where(better, e, best_e)
        best_xc = jnp.where(better[:, None], xc, best_xc)
        best_xd = jnp.where(better[:, None], xd, best_xd)
        return (xc, xd, best_e, best_xc, best_xd), None

    e0 = jax.vmap(energy)(xc, xd)
    carry = (xc, xd, e0, xc, xd)
    carry, _ = jax.lax.scan(
        step, carry, jax.random.split(k_run, cfg.n_steps)
    )
    _, _, best_e, best_xc, best_xd = carry
    i = jnp.argmax(best_e)
    return best_xc[i], best_xd[i], best_e[i]


class HybridMaxWalkSAT:
    """Engine facade: ``HybridMaxWalkSAT(fg).run(key)`` then ``map(rv)``."""

    def __init__(self, fg: CompiledFG, cfg: MWSConfig = MWSConfig()):
        self.fg = fg
        self.cfg = cfg
        self.xc = self.xd = self.energy = None

    def run(self, key, cfg: MWSConfig = None):
        xc, xd, e = run_mws(self.fg, key, cfg or self.cfg)
        self.xc, self.xd = np.asarray(xc), np.asarray(xd)
        self.energy = float(e)
        return self

    def map(self, rv):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            return self.fg.meta.obs_value(rv)
        if kind == "c":
            return float(self.xc[i])
        return self.fg.meta.disc_values(rv)[int(self.xd[i])]
