"""No-U-Turn Sampler (iterative, multinomial) for hybrid MRFs.

BASELINE.json north-star backend ("NUTS/HMC"). The recursive tree doubling
is replaced by a **batched iterative state machine**: all chains advance in
lockstep through a *shared* leaf schedule (depth d = 0, 1, …; leaf j = 0 …
2^d−1 within each doubling), so every leaf costs ONE batched gradient
evaluation for all chains — a single ``[C, n] @ [n, n]`` matmul on
pure-quadratic models (which also yields log-prob for free via
``lp = c + ½·q·(h + g)``), or one vmapped autodiff pass otherwise.

Because the leaf index j is a *scalar* loop counter, the U-turn checkpoint
stack of the iterative formulation (store leaf j at slot popcount(j); when
finishing odd leaf j, check against boundaries j+1−2^l for
l = 1..ctz(j+1)) indexes with scalar slots: checkpoint writes are
``dynamic_update_slice`` on a ``[depth+1, C, n]`` array — no per-chain
scatters. Chains whose trajectory
terminated early (U-turn / divergence / max depth) idle behind masks until
the batch finishes; the loop exits when every chain is done.

Proposals are multinomial (streaming logsumexp weights); discrete latents
move by the same chromatic Gibbs sweeps as ``engines.hmc``. Supports
``collect="moments"`` (streamed sufficient statistics), ``thin`` (inner
loop — never materializes un-thinned samples), and ``shard`` (chain axis
over a mesh) with the same contract as ``hmc.run_hmc``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from lhvi_tpu.utils import struct

from lhvi_tpu.fg.compile import CompiledFG
from lhvi_tpu.engines import hmc as _hmc

Array = jax.Array
_DIVERGENCE = 1000.0


@struct.dataclass
class NUTSConfig:
    max_depth: int = struct.field(pytree_node=False, default=8)
    init_step_size: float = struct.field(pytree_node=False, default=0.1)
    target_accept: float = struct.field(pytree_node=False, default=0.8)
    gibbs_sweeps: int = struct.field(pytree_node=False, default=1)
    gibbs_max_colors: int = struct.field(pytree_node=False, default=0)
    adapt_mass: bool = struct.field(pytree_node=False, default=True)
    jitter: float = struct.field(pytree_node=False, default=1.0)
    # per-color scan unroll for the planned Gibbs sweep (see
    # HMCConfig.gibbs_unroll — pod-scale sweeps are loop-latency bound)
    gibbs_unroll: int = struct.field(pytree_node=False, default=1)
    # orbit-level mode-swap MH move after the Gibbs stage (see
    # HMCConfig.mode_swap / engines/modeswap.py)
    mode_swap: bool = struct.field(pytree_node=False, default=False)
    mode_swap_every: int = struct.field(pytree_node=False, default=1)

    def to_hmc(self) -> "_hmc.HMCConfig":
        """The HMCConfig sharing this config's warmup/Gibbs fields — the
        SINGLE mapping point (init, warmup, and the checkpointed driver
        all route through it; add new shared fields here only)."""
        return _hmc.HMCConfig(
            init_step_size=self.init_step_size,
            target_accept=self.target_accept,
            gibbs_sweeps=self.gibbs_sweeps,
            gibbs_max_colors=self.gibbs_max_colors,
            adapt_mass=self.adapt_mass,
            jitter=self.jitter,
            gibbs_unroll=self.gibbs_unroll,
            mode_swap=self.mode_swap,
            mode_swap_every=self.mode_swap_every,
        )


def _popcount(n):
    return jax.lax.population_count(n.astype(jnp.uint32)).astype(jnp.int32)


def _ctz(n):
    """Count trailing zeros (n > 0)."""
    u = n.astype(jnp.uint32)
    return _popcount((u & (~u + 1)) - 1)


def _make_grad_lp(fg: CompiledFG, xd: Array):
    """Batched (grad, logp) closure: [C, n] -> ([C, n], [C]).

    Pure-quadratic continuous energy: one f32 matmul serves both
    (``g = h − Jq`` and ``lp = c + ½ q·(h + g)``). Otherwise one
    batched vjp over ``fg.log_prob_cont_batched`` at the chains' current
    discrete states: purely-discrete buckets are constant in q per chain,
    so they shift every leaf's Hamiltonian of that chain equally — all
    within-trajectory comparisons (multinomial weights, U-turns,
    divergence ΔH) are exact, and ∇_q is identical to the full log-prob's.
    """
    if fg.cont_pure_quad:
        h, c = fg.quad_h, fg.quad_c
        if fg.quad_sparse:
            def grad_lp(q):
                g = h[None, :] - fg.quad_matvec_batched(q)
                lp = c + 0.5 * jnp.sum(q * (h[None, :] + g), axis=-1)
                return g, lp

            return grad_lp
        J = fg.quad_J

        def grad_lp(q):
            # J symmetric by construction; HIGHEST keeps the gradient and
            # energies feeding the MH/multinomial weights f32, not TF32
            g = h[None, :] - jnp.dot(q, J,
                                     precision=jax.lax.Precision.HIGHEST)
            lp = c + 0.5 * jnp.sum(q * (h[None, :] + g), axis=-1)
            return g, lp

        return grad_lp

    def grad_lp(q):
        lp, pullback = jax.vjp(lambda x: fg.log_prob_cont_batched(x, xd), q)
        return pullback(jnp.ones_like(lp))[0], lp

    return grad_lp


class _NUTS(NamedTuple):
    """Batched trajectory state. [C]-shaped unless noted."""

    step: Array  # scalar: global leaf counter (RNG stream)
    d: Array  # scalar: current doubling depth
    j: Array  # scalar: leaf index within the current subtree
    # trajectory ends and current integration point [C, n]
    q_l: Array
    p_l: Array
    g_l: Array
    q_r: Array
    p_r: Array
    g_r: Array
    q: Array
    p: Array
    g: Array
    q_prop: Array
    sub_q_prop: Array
    h0: Array
    log_w: Array
    sub_log_w: Array
    sum_acc: Array
    n_leaf: Array
    dir: Array  # ±1.0 per chain
    done: Array  # bool: trajectory complete
    sub_bad: Array  # bool: current subtree turned/diverged
    diverged: Array  # bool: sticky divergence flag (diagnostics)
    depth_c: Array  # i32: completed doublings per chain
    q_ck: Array  # [max_depth+1, C, n] checkpoint stack
    p_ck: Array


def _uturn_batched(dq, p_a, p_b, inv_mass):
    """Generalized U-turn test, batched over chains: [C, n] -> [C] bool."""
    im = inv_mass[None, :]
    return (jnp.sum(dq * im * p_a, axis=-1) < 0.0) | (
        jnp.sum(dq * im * p_b, axis=-1) < 0.0
    )


def _nuts_sweep_batched(fg, key, xc, xd, eps, inv_mass, max_depth: int):
    """One NUTS transition for ALL chains (lockstep shared leaf schedule).

    Returns (xc', accept_stat [C], depth [C], diverged [C]). Plain XLA for
    every model; on a sharded chain axis GSPMD partitions it (chains never
    communicate inside a transition).
    """
    C, n = xc.shape
    grad_lp = _make_grad_lp(fg, xd)
    std = jnp.sqrt(1.0 / jnp.maximum(inv_mass, 1e-12))

    k_mom, k_loop = jax.random.split(key)
    p0 = std[None, :] * jax.random.normal(k_mom, (C, n))
    g0, lp0 = grad_lp(xc)
    ke0 = 0.5 * jnp.sum(inv_mass[None, :] * p0 * p0, axis=-1)
    h0 = -lp0 + ke0

    zs = jnp.zeros((C,))
    s0 = _NUTS(
        step=jnp.zeros((), jnp.int32),
        d=jnp.zeros((), jnp.int32),
        j=jnp.zeros((), jnp.int32),
        q_l=xc, p_l=p0, g_l=g0,
        q_r=xc, p_r=p0, g_r=g0,
        q=xc, p=p0, g=g0,
        q_prop=xc, sub_q_prop=xc,
        h0=h0,
        log_w=zs,
        sub_log_w=jnp.full((C,), -jnp.inf),
        sum_acc=zs,
        n_leaf=jnp.zeros((C,), jnp.int32),
        dir=jnp.ones((C,)),
        done=jnp.zeros((C,), bool),
        sub_bad=jnp.zeros((C,), bool),
        diverged=jnp.zeros((C,), bool),
        depth_c=jnp.zeros((C,), jnp.int32),
        q_ck=jnp.zeros((max_depth + 1, C, n)),
        p_ck=jnp.zeros((max_depth + 1, C, n)),
    )

    def start_subtree(s: _NUTS) -> _NUTS:
        """Sample per-chain directions; move the integration point to the
        chosen trajectory end; reset subtree accumulators."""
        kd = jax.random.fold_in(jax.random.fold_in(k_loop, 1), s.step)
        fwd = jax.random.bernoulli(kd, 0.5, (C,))
        go = ~s.done
        dr = jnp.where(go, jnp.where(fwd, 1.0, -1.0), s.dir)
        pick = lambda r, l: jnp.where(fwd[:, None], r, l)
        return s._replace(
            dir=dr,
            q=jnp.where(go[:, None], pick(s.q_r, s.q_l), s.q),
            p=jnp.where(go[:, None], pick(s.p_r, s.p_l), s.p),
            g=jnp.where(go[:, None], pick(s.g_r, s.g_l), s.g),
            sub_q_prop=s.q,
            sub_log_w=jnp.full((C,), -jnp.inf),
            sub_bad=jnp.zeros((C,), bool),
        )

    def leaf(s: _NUTS) -> _NUTS:
        """One leapfrog leaf for every active chain (single batched grad)."""
        active = ~s.done & ~s.sub_bad
        e = (s.dir * eps)[:, None]
        p_half = s.p + 0.5 * e * s.g
        q_new = s.q + e * inv_mass[None, :] * p_half
        g_new, lp_new = grad_lp(q_new)
        p_new = p_half + 0.5 * e * g_new

        h = -lp_new + 0.5 * jnp.sum(inv_mass[None, :] * p_new * p_new, -1)
        dh = h - s.h0
        div = ~jnp.isfinite(dh) | (dh > _DIVERGENCE)
        lw = jnp.where(div, -jnp.inf, -dh)
        acc_term = jnp.where(jnp.isfinite(dh),
                             jnp.minimum(1.0, jnp.exp(-dh)), 0.0)

        # streaming multinomial proposal within the subtree
        kl = jax.random.fold_in(jax.random.fold_in(k_loop, 2), s.step)
        u = jax.random.uniform(kl, (C,))
        sub_log_w = jnp.logaddexp(s.sub_log_w, jnp.where(active, lw, -jnp.inf))
        take = active & (jnp.log(u) < (lw - sub_log_w)) & ~div
        sub_q_prop = jnp.where(take[:, None], q_new, s.sub_q_prop)

        am = active[:, None]
        q = jnp.where(am, q_new, s.q)
        p = jnp.where(am, p_new, s.p)
        g = jnp.where(am, g_new, s.g)

        # checkpoint even leaves at scalar slot popcount(j)
        slot = _popcount(s.j)
        is_even = (s.j % 2) == 0

        def ck_write(ck, val):
            cur = jax.lax.dynamic_slice_in_dim(ck, slot, 1, axis=0)[0]
            new = jnp.where(am, val, cur)
            return jax.lax.dynamic_update_slice_in_dim(
                ck, new[None], slot, axis=0
            )

        q_ck = jax.lax.cond(
            is_even, lambda: ck_write(s.q_ck, q_new), lambda: s.q_ck
        )
        p_ck = jax.lax.cond(
            is_even, lambda: ck_write(s.p_ck, p_new), lambda: s.p_ck
        )

        # U-turn checks for odd leaves against stored subtree boundaries
        def check_turn(turn):
            n_checks = _ctz(s.j + 1)

            def body(l, t):
                b = s.j + 1 - (1 << (l + 1))
                sl = _popcount(b)
                qb = jax.lax.dynamic_slice_in_dim(q_ck, sl, 1, axis=0)[0]
                pb = jax.lax.dynamic_slice_in_dim(p_ck, sl, 1, axis=0)[0]
                dq = (q_new - qb) * s.dir[:, None]
                return t | (
                    active
                    & _uturn_batched(
                        dq,
                        pb * s.dir[:, None],
                        p_new * s.dir[:, None],
                        inv_mass,
                    )
                )

            return jax.lax.fori_loop(0, n_checks, body, turn)

        turned = jax.lax.cond(
            (s.j % 2) == 1, check_turn, lambda t: t,
            jnp.zeros((C,), bool),
        )
        sub_bad = s.sub_bad | (active & (div | turned))
        return s._replace(
            q=q, p=p, g=g,
            sub_q_prop=sub_q_prop,
            sub_log_w=sub_log_w,
            sum_acc=s.sum_acc + jnp.where(active, acc_term, 0.0),
            n_leaf=s.n_leaf + active.astype(jnp.int32),
            diverged=s.diverged | (active & div),
            sub_bad=sub_bad,
            q_ck=q_ck, p_ck=p_ck,
            j=s.j + 1,
            step=s.step + 1,
        )

    def merge(s: _NUTS) -> _NUTS:
        """Fold the completed subtree into the trajectory (biased
        progressive sampling), update the ends, global U-turn check."""
        going = ~s.done
        bad = s.sub_bad
        km = jax.random.fold_in(jax.random.fold_in(k_loop, 3), s.step)
        u = jax.random.uniform(km, (C,))
        take_new = going & ~bad & (jnp.log(u) < (s.sub_log_w - s.log_w))
        q_prop = jnp.where(take_new[:, None], s.sub_q_prop, s.q_prop)
        log_w = jnp.where(
            going & ~bad, jnp.logaddexp(s.log_w, s.sub_log_w), s.log_w
        )

        ok = (going & ~bad)[:, None]
        fwd = s.dir[:, None] > 0
        q_l = jnp.where(ok & ~fwd, s.q, s.q_l)
        p_l = jnp.where(ok & ~fwd, s.p, s.p_l)
        g_l = jnp.where(ok & ~fwd, s.g, s.g_l)
        q_r = jnp.where(ok & fwd, s.q, s.q_r)
        p_r = jnp.where(ok & fwd, s.p, s.p_r)
        g_r = jnp.where(ok & fwd, s.g, s.g_r)

        turn_glob = _uturn_batched(q_r - q_l, p_l, p_r, inv_mass)
        done = s.done | bad | (going & turn_glob)
        depth_c = jnp.where(going, s.d + 1, s.depth_c)
        return s._replace(
            q_l=q_l, p_l=p_l, g_l=g_l,
            q_r=q_r, p_r=p_r, g_r=g_r,
            q_prop=q_prop, log_w=log_w,
            done=done, depth_c=depth_c,
            d=s.d + 1, j=jnp.zeros((), jnp.int32),
        )

    def cond(s: _NUTS):
        return jnp.any(~s.done) & (s.d < max_depth)

    def body(s: _NUTS):
        s = jax.lax.cond(s.j == 0, start_subtree, lambda x: x, s)
        s = leaf(s)
        return jax.lax.cond(s.j == (1 << s.d), merge, lambda x: x, s)

    s = jax.lax.while_loop(cond, body, s0)
    accept = s.sum_acc / jnp.maximum(s.n_leaf, 1).astype(jnp.float32)
    return s.q_prop, accept, s.depth_c, s.diverged


def nuts_transition(fg: CompiledFG, cfg: NUTSConfig, state: "_hmc.HMCState",
                    key, adapt: bool):
    """One NUTS-within-Gibbs transition for all chains. Returns
    ``(state, (acc [C], depth [C], div [C]))`` — the unit the run/warmup
    scans and the checkpointed driver are built from."""
    hcfg = cfg.to_hmc()
    k_g, k_n, k_ms = jax.random.split(key, 3)
    xd = (_hmc.sweep_all(fg, hcfg, k_g, state.xc, state.xd)
          if fg.n_disc else state.xd)
    if cfg.mode_swap and fg.mode_swap_plan is not None:
        from lhvi_tpu.engines.modeswap import maybe_mode_swap

        xd, ms_acc, n_inc = maybe_mode_swap(fg, cfg, k_ms, state.xc, xd)
        state = state._replace(ms_acc_sum=state.ms_acc_sum + ms_acc,
                               ms_acc_n=state.ms_acc_n + n_inc)
    if fg.n_cont == 0:
        C = state.xc.shape[0]
        state = state._replace(xd=xd)
        return state, (jnp.ones((C,)), jnp.zeros((C,), jnp.int32),
                       jnp.zeros((C,), bool))
    eps = jnp.exp(state.log_eps)
    xc, acc, depth, div = _nuts_sweep_batched(
        fg, k_n, state.xc, xd, eps, state.inv_mass, cfg.max_depth,
    )
    state = state._replace(xc=xc, xd=xd)
    if adapt:
        state = _hmc._da_update(state, jnp.mean(acc), hcfg)
        state = _hmc._welford_update(state, xc)
    return state, (acc, depth, div)


def run_nuts(
    fg: CompiledFG,
    key: Array,
    cfg: NUTSConfig = NUTSConfig(),
    n_chains: int = 8,
    n_warmup: int = 500,
    n_samples: int = 1000,
    thin: int = 1,
    collect: str = "samples",
    shard=None,
    stream_diag: bool = True,
    disc_diag_cap: int = 4096,
):
    """NUTS-within-Gibbs over the compiled graph; same contract as
    ``hmc.run_hmc`` (collect="samples"|"moments", thin streams inside the
    scan, shard distributes the chain axis over a mesh, stream_diag
    carries the streamed split-R̂/ESS accumulators — set False for
    pure-throughput measurement; disc_diag_cap bounds the streamed
    discrete-value split-R̂ selection)."""
    want_disc = (collect == "moments" and stream_diag and fg.n_disc > 0
                 and disc_diag_cap > 0)
    disc_sel = (tuple(int(i)
                      for i in _hmc.disc_diag_select(fg, disc_diag_cap))
                if want_disc else None)
    fg, cfg = _hmc._ensure_mode_swap_plan(fg, cfg)
    return _run_nuts(fg, key, cfg, n_chains=n_chains, n_warmup=n_warmup,
                     n_samples=n_samples, thin=thin, collect=collect,
                     shard=shard, stream_diag=stream_diag,
                     disc_sel=disc_sel)


@partial(jax.jit, static_argnames=("n_chains", "n_warmup", "n_samples",
                                   "thin", "collect", "shard",
                                   "stream_diag", "disc_sel"))
def _run_nuts(
    fg: CompiledFG,
    key: Array,
    cfg: NUTSConfig,
    n_chains: int,
    n_warmup: int,
    n_samples: int,
    thin: int,
    collect: str,
    shard,
    stream_diag: bool,
    disc_sel,
):
    k_init, k_warm, k_samp = jax.random.split(key, 3)
    hcfg = cfg.to_hmc()
    state = _hmc.init_hmc_state(fg, k_init, hcfg, n_chains, shard)

    def transition(state, key, adapt):
        return nuts_transition(fg, cfg, state, key, adapt)

    state = _hmc.run_warmup(
        fg, hcfg, state, k_warm, n_warmup,
        lambda s, k, adapt: (lambda s2, o: (s2, o[0]))(
            *transition(s, k, adapt)
        ),
    )
    # mode-swap acceptance is reported for the SAMPLING window only (like
    # accept_rate): drop the warmup-phase accumulation
    state = state._replace(ms_acc_sum=jnp.zeros(()),
                           ms_acc_n=jnp.zeros(()))

    def sample_step(state, key):
        def inner(t, carry):
            state, _ = carry
            state, stats = transition(state, jax.random.fold_in(key, t),
                                      False)
            return state, stats
        C = state.xc.shape[0]
        init_stats = (jnp.zeros((C,)), jnp.zeros((C,), jnp.int32),
                      jnp.zeros((C,), bool))
        state, (acc, depth, div) = jax.lax.fori_loop(
            0, thin, inner, (state, init_stats)
        )
        return state, (acc, depth, div)

    if collect == "moments":
        half = n_samples // 2
        bm_len, n_batches = _hmc._bm_schedule(n_samples)
        want_disc = disc_sel is not None
        sel = np.asarray(disc_sel, np.int32) if want_disc else None

        def moment_step(carry, inp):
            key, t = inp
            state, s1, s2, cnt, sd, sdd = carry
            state, (acc, depth, div) = sample_step(state, key)
            s1 = s1 + jnp.sum(state.xc, axis=0)
            s2 = s2 + jnp.sum(state.xc * state.xc, axis=0)
            if fg.n_disc:
                oh = jax.nn.one_hot(state.xd, fg.max_v, dtype=jnp.float32)
                cnt = cnt + jnp.sum(oh, axis=0)
            if stream_diag:
                sd = _hmc._stream_diag_update(sd, t, state.xc, half,
                                              bm_len, n_batches)
            if want_disc:
                sdd = _hmc._stream_diag_disc_update(
                    sdd, t, _hmc._disc_sel_values(fg, sel, state.xd), half)
            return (state, s1, s2, cnt, sd, sdd), (
                jnp.mean(acc),
                jnp.mean(depth.astype(jnp.float32)),
                jnp.mean(div.astype(jnp.float32)),
            )

        z1 = jnp.zeros(fg.n_cont)
        z2 = jnp.zeros(fg.n_cont)
        zc = jnp.zeros((max(fg.n_disc, 1), fg.max_v))
        sd0 = (_hmc._stream_diag_init(n_chains, fg.n_cont) if stream_diag
               else ())
        sdd0 = (_hmc._stream_diag_disc_init(n_chains, len(sel))
                if want_disc else ())
        (state, s1, s2, cnt, sd, sdd), (accs, depths, divs) = jax.lax.scan(
            moment_step, (state, z1, z2, zc, sd0, sdd0),
            (jax.random.split(k_samp, n_samples),
             jnp.arange(n_samples, dtype=jnp.int32)),
        )
        n_obs = n_samples * n_chains
        mean = s1 / n_obs
        var = jnp.maximum(s2 / n_obs - mean**2, 0.0)
        moments = {
            "mean": mean,
            "var": var,
            "disc_probs": cnt / n_obs,
            "n_obs": n_obs,
        }
        diag = {
            "accept_rate": jnp.mean(accs),
            "mean_depth": jnp.mean(depths),
            "divergence_rate": jnp.mean(divs),
            "step_size": jnp.exp(state.log_eps),
            "inv_mass": state.inv_mass,
            **({"mode_swap_accept":
                state.ms_acc_sum / jnp.maximum(state.ms_acc_n, 1.0)}
               if cfg.mode_swap else {}),
            **(_hmc._stream_diag_finalize(sd, n_samples, bm_len)
               if stream_diag else {}),
            **(_hmc._stream_diag_disc_finalize(sdd, n_samples)
               if want_disc else {}),
        }
        if want_disc:
            diag["disc_diag_idx"] = jnp.asarray(sel)
        return moments, None, diag

    def collect_step(state, key):
        state, (acc, depth, div) = sample_step(state, key)
        return state, (state.xc, state.xd, jnp.mean(acc),
                       jnp.mean(depth.astype(jnp.float32)),
                       jnp.mean(div.astype(jnp.float32)))

    state, (s_xc, s_xd, accs, depths, divs) = jax.lax.scan(
        collect_step, state, jax.random.split(k_samp, n_samples)
    )
    diag = {
        "accept_rate": jnp.mean(accs),
        "mean_depth": jnp.mean(depths),
        "divergence_rate": jnp.mean(divs),
        "step_size": jnp.exp(state.log_eps),
        "inv_mass": state.inv_mass,
        **({"mode_swap_accept":
            state.ms_acc_sum / jnp.maximum(state.ms_acc_n, 1.0)}
           if cfg.mode_swap else {}),
    }
    return s_xc, s_xd, diag


def sample(fg: CompiledFG, key, **kw):
    cfg = kw.pop("cfg", NUTSConfig())
    if kw.get("collect") == "moments":
        moments, _, diag = run_nuts(fg, key, cfg, **kw)
        return _hmc.HMCMoments(fg, moments, diag)
    s_xc, s_xd, diag = run_nuts(fg, key, cfg, **kw)
    return _hmc.HMCResult(fg, s_xc, s_xd, diag)
