"""Annealed Sequential Monte Carlo with systematic resampling.

New backend mandated by BASELINE.json's north-star (the reference has no
SMC). Targets the full joint of any compiled factor graph by likelihood
tempering: particles start from a broad base distribution q0 and follow the
path  log π_β = (1−β)·log q0 + β·log p  over a fixed β-grid, with

- importance reweighting between temperatures (and a running log-Z
  estimate),
- ESS-triggered **systematic resampling** (sorted-uniform positions →
  ``searchsorted`` gather; on a sharded particle axis XLA lowers the
  cumulative-weight gather to all-gather + permute collectives —
  SURVEY.md §9 hard part (d)),
- HMC rejuvenation moves on continuous latents + tempered chromatic-Gibbs
  moves on discrete latents at each temperature.

The particle axis is the unit of data parallelism: ``lhvi_tpu.parallel``
shards it over the mesh.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from lhvi_tpu.utils import struct

from lhvi_tpu.fg.compile import CompiledFG
from lhvi_tpu.ops.resample import systematic_parents, weight_pipeline

Array = jax.Array


@struct.dataclass
class SMCConfig:
    n_particles: int = struct.field(pytree_node=False, default=1024)
    n_temps: int = struct.field(pytree_node=False, default=40)
    n_moves: int = struct.field(pytree_node=False, default=2)
    n_leapfrog: int = struct.field(pytree_node=False, default=5)
    step_size: float = struct.field(pytree_node=False, default=0.25)
    ess_frac: float = struct.field(pytree_node=False, default=0.5)
    base_scale: float = struct.field(pytree_node=False, default=2.0)
    # batched fused-quadratic rejuvenation moves (ops.leapfrog
    # quad_leapfrog on the blended tempered (J,h)) when the model is
    # pure-quadratic. Off by default: the anneal is bound by the
    # per-temperature reweight/resample step, and the vmapped autodiff
    # leapfrog keeps every model on one code path.
    # NOTE: this flag gates the DENSE path only. Pure-quad ELL (sparse)
    # models always take the fused sparse move: the explicit ∇ = h − Jx
    # matvec avoids autodiff's scatter-adds through the gather with
    # identical proposals, so there is no trade-off to expose —
    # quad_moves=False does not opt ELL models back to move_batched.
    quad_moves: bool = struct.field(pytree_node=False, default=False)
    # --- adaptive tempering -------------------------------
    # CESS-targeted β schedule: each temperature picks the largest Δβ
    # whose CONDITIONAL ESS stays ≥ ess_target·N (bisection; ``n_temps`` stays
    # the STATIC scan cap so the program jits once — steps after β reaches
    # 1 are runtime no-ops, and the last step forces β = 1 so a stiff
    # target can never leave the anneal unfinished). Plus Robbins–Monro
    # per-temperature rejuvenation step-size adaptation from the accept
    # trace (fixed-grid runs silently lose rejuvenation acceptance on
    # stiff targets; the trace was logged but unused before round 4).
    adaptive: bool = struct.field(pytree_node=False, default=False)
    ess_target: float = struct.field(pytree_node=False, default=0.9)
    target_accept: float = struct.field(pytree_node=False, default=0.65)
    rm_gain: float = struct.field(pytree_node=False, default=0.5)
    # orbit-level mode-swap MH move after each tempered Gibbs stage (see
    # hmc.HMCConfig.mode_swap / engines/modeswap.py) — accepted against
    # π^β, matching the tempered Gibbs logits
    mode_swap: bool = struct.field(pytree_node=False, default=False)


class SMCState(NamedTuple):
    xc: Array  # [N, n_cont]
    xd: Array  # [N, n_disc]
    log_w: Array  # [N] unnormalized
    log_z: Array  # running evidence estimate
    key: Array


def _base_log_prob(fg: CompiledFG, cfg: SMCConfig, xc: Array) -> Array:
    mid = 0.5 * (fg.cont_lo + fg.cont_hi)
    scale = cfg.base_scale * jnp.ones_like(mid)
    z = (xc - mid) / scale
    lp = jnp.sum(-0.5 * z * z - jnp.log(scale) - 0.5 * jnp.log(2 * jnp.pi), -1)
    # uniform base over discrete latents (constant, but keeps log-Z honest)
    return lp - jnp.sum(jnp.log(fg.disc_sizes.astype(jnp.float32)))


def systematic_resample(key: Array, log_w: Array, n: int) -> Array:
    """Systematic resampling: returns i32[n] parent indices.

    Deterministic given one uniform draw — no per-particle host sync; the
    ``searchsorted`` over the cumulative weights is the only cross-particle
    dependency (a gather / all-gather when sharded).
    """
    w = jax.nn.softmax(log_w)
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key, ())
    pos = (jnp.arange(n) + u0) / n
    return jnp.clip(jnp.searchsorted(cum, pos), 0, log_w.shape[0] - 1).astype(
        jnp.int32
    )


def _choose_beta(log_w: Array, delta_lp: Array, beta: Array,
                 target_log_cess: Array, n_iters: int = 26) -> Array:
    """Largest β′ ∈ (β, 1] whose CONDITIONAL ESS ≥ the target (bisection).

    CESS (Zhou–Johansen–Aston 2016): with normalized weights W and
    incremental weights u = exp(Δβ·delta_lp),
    ``CESS = N·(Σ W u)² / Σ W u²`` — the quality of THIS reweighting step
    alone. Plain ESS would stall: entering weights often already sit at
    the target, so any Δβ > 0 fails and the anneal crawls at the floor.
    CESS → N as Δβ → 0 regardless of current degeneracy.

    ``log_w`` enters normalized; ``delta_lp = log p − log q0`` at the
    current particles. CESS is monotone decreasing in Δβ, so bisection
    converges geometrically; 26 iterations pin Δβ to ~1e-8. A 1e-3·(1−β)
    floor keeps the anneal advancing even when the target is unreachable
    (pathologically heavy-tailed weights). On a sharded particle axis the
    logsumexps lower to psums.
    """
    from jax.scipy.special import logsumexp

    hi0 = 1.0 - beta
    logN = jnp.log(1.0 * log_w.shape[0])

    def ok(d):
        lcess = logN + 2.0 * logsumexp(log_w + d * delta_lp) - logsumexp(
            log_w + 2.0 * d * delta_lp
        )
        return lcess >= target_log_cess

    def bisect(_):
        def body(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            good = ok(mid)
            return jnp.where(good, mid, lo), jnp.where(good, hi, mid)

        lo, _ = jax.lax.fori_loop(
            0, n_iters, body, (jnp.zeros(()), hi0)
        )
        return lo  # largest known-good Δβ

    delta = jax.lax.cond(ok(hi0), lambda _: hi0, bisect, None)
    return beta + jnp.maximum(delta, hi0 * 1e-3)


@partial(jax.jit, static_argnames=("cfg", "shard"))
def run_smc(fg: CompiledFG, key: Array, cfg: SMCConfig = SMCConfig(),
            shard=None):
    """Returns (xc [N,n_cont], xd [N,n_disc], log_w [N], log_z, diag).

    ``shard``: optional ``NamedSharding`` for the particle axis (e.g. from
    ``lhvi_tpu.parallel.chain_sharding``). The whole anneal then runs with
    particles distributed over the mesh: weight normalization/ESS become
    psums and the systematic-resampling gather becomes all-gather +
    permute collectives, all inserted by XLA.
    """
    N = cfg.n_particles
    from lhvi_tpu.engines.hmc import _ensure_mode_swap_plan

    fg, cfg = _ensure_mode_swap_plan(fg, cfg)
    k0, key = jax.random.split(key)
    mid = 0.5 * (fg.cont_lo + fg.cont_hi)
    kc, kd = jax.random.split(k0)
    xc = mid + cfg.base_scale * jax.random.normal(kc, (N, fg.n_cont))
    xd = jnp.floor(
        jax.random.uniform(kd, (N, fg.n_disc)) * fg.disc_sizes
    ).astype(jnp.int32)
    if shard is not None:
        xc = jax.lax.with_sharding_constraint(xc, shard)
        xd = jax.lax.with_sharding_constraint(xd, shard)

    betas = jnp.linspace(0.0, 1.0, cfg.n_temps + 1)

    def anneal_step(state: SMCState, beta_prev, beta, step, delta_lp=None):
        """Shared reweight → resample → rejuvenate body. ``step`` is the
        rejuvenation step size (python float on the fixed grid, carried
        tracer when adaptive); ``delta_lp`` lets the adaptive driver reuse
        the log-prob evaluation its β-chooser already paid for."""
        key, k_res, k_mom, k_acc, k_gibbs = jax.random.split(state.key, 5)
        xc, xd, log_w = state.xc, state.xd, state.log_w

        # --- reweight: incremental weight between temperatures ------------
        # invariant: log_w enters normalized (logsumexp == 0)
        if delta_lp is None:
            lp_full = fg.log_prob_batched(xc, xd)
            lp_base = _base_log_prob(fg, cfg, xc)
            delta_lp = lp_full - lp_base
        inc = (beta - beta_prev) * delta_lp
        lw_unnorm = log_w + inc
        # normalize + ESS + cumulative weights (psums on a sharded axis)
        lw_norm, cum, step_z, ess = weight_pipeline(lw_unnorm)
        log_z = state.log_z + step_z

        # --- ESS-triggered systematic resampling ---------------------------
        def do_resample(args):
            xc, xd, _ = args
            idx = systematic_parents(k_res, cum, N)
            xc, xd = xc[idx], xd[idx]
            if shard is not None:
                xc = jax.lax.with_sharding_constraint(xc, shard)
                xd = jax.lax.with_sharding_constraint(xd, shard)
            return xc, xd, jnp.full(N, -jnp.log(1.0 * N))

        need = ess < cfg.ess_frac * N
        xc, xd, log_w = jax.lax.cond(
            need, do_resample, lambda a: a, (xc, xd, lw_norm)
        )

        # --- rejuvenation moves -------------------------------------------
        def move(carry, k):
            xc, xd = carry
            km, ka, kg = jax.random.split(k, 3)

            # HMC move on the tempered target — LOCKSTEP batched leapfrog
            # on the continuous-state-dependent part (purely-discrete
            # buckets are constant in xc at each particle's fixed xd and
            # cancel exactly in the MH ratio)
            def move_batched(km, ka, xc, xd):
                # batched leapfrog on the tempered target via
                # ops/logpot.py. The base-measure constants dropped by
                # logpot_leapfrog cancel in h0−h1.
                from lhvi_tpu.ops.logpot import logpot_leapfrog

                mid = 0.5 * (fg.cont_lo + fg.cont_hi)
                scale = cfg.base_scale * jnp.ones_like(mid)
                p0 = jax.random.normal(km, xc.shape)
                x1, p1, lp0, lp1 = logpot_leapfrog(
                    fg, xc, p0, xd, jnp.ones(fg.n_cont), step,
                    cfg.n_leapfrog, beta=beta, base_mid=mid,
                    base_inv_s2=1.0 / (scale * scale),
                )
                h0 = -lp0 + 0.5 * jnp.sum(p0 * p0, -1)
                h1 = -lp1 + 0.5 * jnp.sum(p1 * p1, -1)
                ok = (
                    jnp.log(jax.random.uniform(ka, (N,)))
                    < jnp.minimum(0.0, h0 - h1)
                ) & jnp.isfinite(h1)
                return jnp.where(ok[:, None], x1, xc), ok

            def move_quad(km, ka, xc):
                # the tempered target of a pure-quadratic model is itself
                # quadratic — β·(J,h) + (1−β)·(I/s², mid/s²) — so all
                # particles ride the fused quad leapfrog at once, like
                # hmc._hmc_step_batched; constants cancel in the MH ratio
                from lhvi_tpu.ops.leapfrog import quad_leapfrog

                s2 = cfg.base_scale ** 2
                n = fg.n_cont
                Jb = beta * fg.quad_J + (1.0 - beta) * jnp.eye(n) / s2
                hb = beta * fg.quad_h + (1.0 - beta) * mid / s2
                hi = jax.lax.Precision.HIGHEST
                lp = lambda X: (
                    -0.5 * jnp.einsum("ci,ij,cj->c", X, Jb, X, precision=hi)
                    + jnp.dot(X, hb, precision=hi)
                )
                p0 = jax.random.normal(km, xc.shape)
                # shard: the leapfrog kernel dispatches one instance per
                # device (particles never communicate inside a move)
                x1, p1 = quad_leapfrog(
                    xc, p0, Jb, hb, jnp.ones(n), step,
                    cfg.n_leapfrog, shard=shard,
                )
                h0 = -lp(xc) + 0.5 * jnp.sum(p0 * p0, -1)
                h1 = -lp(x1) + 0.5 * jnp.sum(p1 * p1, -1)
                ok = (
                    jnp.log(jax.random.uniform(ka, (N,)))
                    < jnp.minimum(0.0, h0 - h1)
                ) & jnp.isfinite(h1)
                return jnp.where(ok[:, None], x1, xc), ok

            def move_quad_sparse(km, ka, xc):
                # the tempered target of a pure-quadratic ELL model is
                # itself ELL with the SAME neighbor table: β·(diag, w, h)
                # + (1−β)·(1/s², 0, mid/s²) only rescales the diagonal
                # and weights — so particles ride the fused sparse
                # leapfrog (explicit ∇ = h − Jx matvec; autodiff through
                # the gather would lower to scatter-adds on the backward
                # pass). Endpoint gradients give both energies for free.
                # BANDED targets ride the DIA proposal instead. The
                # β-blend happens in LATENT space before the
                # gather-embedding, so the prior's (1−β)/s² diagonal
                # never lands on evidence gap lanes (the sentinel column
                # zeroes them).
                from lhvi_tpu.ops.dia import dia_hmc_proposal
                from lhvi_tpu.ops.leapfrog import ell_quad_leapfrog

                s2 = cfg.base_scale ** 2
                if fg.quad_dia_offsets is not None:
                    diag_b = beta * fg.quad_diag + (1.0 - beta) / s2
                    hb = beta * fg.quad_h + (1.0 - beta) * mid / s2
                    x1, log_acc = dia_hmc_proposal(
                        km, xc, diag_b, fg.quad_dia_offsets,
                        beta * fg.quad_dia_w, hb, jnp.ones(fg.n_cont),
                        step, cfg.n_leapfrog,
                        pos=fg.quad_dia_pos, inv=fg.quad_dia_inv,
                    )
                    ok = jnp.log(jax.random.uniform(ka, (N,))) < log_acc
                    return jnp.where(ok[:, None], x1, xc), ok
                diag_b = beta * fg.quad_diag + (1.0 - beta) / s2
                w_b = beta * fg.quad_ell_w
                hb = beta * fg.quad_h + (1.0 - beta) * mid / s2
                p0 = jax.random.normal(km, xc.shape)
                x1, p1, g0, g1 = ell_quad_leapfrog(
                    xc, p0, diag_b, fg.quad_ell_col, w_b, hb,
                    jnp.ones(fg.n_cont), step, cfg.n_leapfrog,
                )
                lp0 = 0.5 * jnp.sum(xc * (hb[None] + g0), -1)
                lp1 = 0.5 * jnp.sum(x1 * (hb[None] + g1), -1)
                h0 = -lp0 + 0.5 * jnp.sum(p0 * p0, -1)
                h1 = -lp1 + 0.5 * jnp.sum(p1 * p1, -1)
                ok = (
                    jnp.log(jax.random.uniform(ka, (N,)))
                    < jnp.minimum(0.0, h0 - h1)
                ) & jnp.isfinite(h1)
                return jnp.where(ok[:, None], x1, xc), ok

            # pure-quad ELL models ALWAYS take the sparse fused move
            # (mirrors hmc._hmc_step_batched — the explicit matvec beats
            # autodiff-with-scatters; GSPMD partitions it natively).
            # Dense quad_moves stays opt-in (see SMCConfig.quad_moves).
            if fg.n_cont and fg.cont_pure_quad and fg.quad_sparse:
                xc, acc = move_quad_sparse(km, ka, xc)
            elif (fg.n_cont and fg.cont_pure_quad and cfg.quad_moves
                    and not fg.quad_sparse):
                xc, acc = move_quad(km, ka, xc)
            elif fg.n_cont:
                xc, acc = move_batched(km, ka, xc, xd)
            else:
                acc = jnp.ones(N, bool)

            # tempered Gibbs for discrete latents (planned per-color
            # tables when compiled — see hmc.gibbs_sweep_planned)
            if fg.n_disc:
                if fg.color_plan is not None:
                    from lhvi_tpu.engines.hmc import gibbs_sweep_planned

                    xd = jax.vmap(
                        lambda kg_i, xc_i, xd_i: gibbs_sweep_planned(
                            fg, kg_i, xc_i, xd_i, beta=beta
                        )
                    )(jax.random.split(kg, N), xc, xd)
                else:
                    def gibbs_one(kg_i, xc_i, xd_i):
                        def color_step(xd_i, cinp):
                            kk, c = cinp
                            logits = beta * fg.disc_logits(xc_i, xd_i)
                            new = jax.random.categorical(
                                kk, logits, -1
                            ).astype(jnp.int32)
                            return jnp.where(fg.color_of == c, new, xd_i), None

                        ks = jax.random.split(kg_i, fg.n_colors)
                        colors = jnp.arange(fg.n_colors, dtype=jnp.int32)
                        out, _ = jax.lax.scan(color_step, xd_i, (ks, colors))
                        return out

                    xd = jax.vmap(gibbs_one)(jax.random.split(kg, N), xc, xd)
                if cfg.mode_swap and fg.mode_swap_plan is not None:
                    from lhvi_tpu.engines.modeswap import mode_swap_sweep

                    # fold_in(kg, i) is bit-identical to split(kg, N)[i]
                    # (threefry) — fold at N, PAST the per-particle Gibbs
                    # keys, so the move's variates never reuse a stream
                    # that just updated a particle's state
                    xd, _ = mode_swap_sweep(
                        fg, jax.random.fold_in(kg, N), xc, xd,
                        fg.mode_swap_plan, beta=beta,
                    )
            return (xc, xd), jnp.mean(acc.astype(jnp.float32))

        (xc, xd), accs = jax.lax.scan(
            move, (xc, xd), jax.random.split(k_acc, cfg.n_moves)
        )

        new = SMCState(xc=xc, xd=xd, log_w=log_w, log_z=log_z, key=key)
        return new, (ess, jnp.mean(accs))

    state = SMCState(
        xc=xc,
        xd=xd,
        log_w=jnp.full(N, -jnp.log(1.0 * N)),  # normalized uniform
        log_z=jnp.zeros(()),
        key=key,
    )
    if not cfg.adaptive:
        def temp_step(state: SMCState, inp):
            beta_prev, beta = inp
            new, ys = anneal_step(state, beta_prev, beta, cfg.step_size)
            return new, ys + (beta,)

        state, (ess_tr, acc_tr, beta_tr) = jax.lax.scan(
            temp_step, state, (betas[:-1], betas[1:])
        )
        n_used = jnp.asarray(cfg.n_temps)
        final_step = jnp.asarray(cfg.step_size)
    else:
        target_log_cess = jnp.log(cfg.ess_target * N)

        def temp_step(carry, t_idx):
            def run(carry):
                state, beta_prev, log_step = carry
                lp_full = fg.log_prob_batched(state.xc, state.xd)
                lp_base = _base_log_prob(fg, cfg, state.xc)
                delta_lp = lp_full - lp_base
                beta = _choose_beta(
                    state.log_w, delta_lp, beta_prev, target_log_cess
                )
                # the static cap must never truncate the anneal short of
                # β = 1 (a truncated anneal silently biases log-Z)
                beta = jnp.where(t_idx >= cfg.n_temps - 1, 1.0, beta)
                new, (ess, acc) = anneal_step(
                    state, beta_prev, beta, jnp.exp(log_step),
                    delta_lp=delta_lp,
                )
                # Deadband Robbins–Monro on log step size: shrink when
                # acceptance falls below target (the stiff-target failure
                # mode), grow only when it exceeds 0.95 (step clearly too
                # small). A symmetric pull toward target_accept would
                # INFLATE the step on easy targets until acceptance drops
                # to the target by construction — measured +66% log-Z
                # error on the LDS config.
                delta = jnp.where(
                    acc < cfg.target_accept, acc - cfg.target_accept,
                    jnp.maximum(acc - 0.95, 0.0),
                )
                log_step = log_step + cfg.rm_gain * delta
                return (new, beta, log_step), (ess, acc, beta)

            def skip(carry):
                state, beta_prev, log_step = carry
                return carry, (jnp.asarray(1.0 * N), jnp.asarray(1.0),
                               beta_prev)

            state, beta_prev, _ = carry
            return jax.lax.cond(beta_prev < 1.0, run, skip, carry)

        (state, _, log_step_f), (ess_tr, acc_tr, beta_tr) = jax.lax.scan(
            temp_step,
            (state, jnp.zeros(()), jnp.log(jnp.asarray(cfg.step_size))),
            jnp.arange(cfg.n_temps),
        )
        n_used = jnp.sum(
            jnp.concatenate([jnp.zeros((1,)), beta_tr[:-1]]) < 1.0
        ).astype(jnp.int32)
        final_step = jnp.exp(log_step_f)
    # log_z accumulated log(Σ w·inc) per step with normalized weights, so it
    # estimates log(Z_p / Z_q0); q0 here is normalized, i.e. log_z ≈ log Z.
    diag = {"ess": ess_tr, "accept": acc_tr, "log_z": state.log_z,
            "betas": beta_tr, "n_temps_used": n_used,
            "final_step": final_step}
    return state.xc, state.xd, state.log_w, state.log_z, diag


class SMCResult:
    """Weighted-particle queries."""

    def __init__(self, fg: CompiledFG, xc, xd, log_w, log_z, diag):
        self.fg = fg
        self.xc = np.asarray(xc)
        self.xd = np.asarray(xd)
        w = np.asarray(jax.nn.softmax(log_w))
        self.w = w
        self.log_z = float(log_z)
        self.diag = diag

    def _loc(self, rv, want):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            raise ValueError(f"{rv} is observed (evidence); it has no posterior")
        if kind != want:
            raise ValueError(f"{rv} is {'continuous' if kind == 'c' else 'discrete'}")
        return i

    def mean(self, rv) -> float:
        i = self._loc(rv, "c")
        return float(np.sum(self.w * self.xc[:, i]))

    def var(self, rv) -> float:
        i = self._loc(rv, "c")
        m = self.mean(rv)
        return float(np.sum(self.w * (self.xc[:, i] - m) ** 2))

    def disc_marginal(self, rv) -> np.ndarray:
        i = self._loc(rv, "d")
        size = self.fg.meta.disc_size(rv)
        out = np.zeros(size)
        np.add.at(out, self.xd[:, i], self.w)
        return out

    def map(self, rv):
        kind, _ = self.fg.meta.loc(rv)
        if kind == "c":
            return self.mean(rv)
        p = self.disc_marginal(rv)
        return self.fg.meta.disc_values(rv)[int(p.argmax())]


def sample(fg: CompiledFG, key, cfg: SMCConfig = SMCConfig(),
           shard=None) -> SMCResult:
    xc, xd, log_w, log_z, diag = run_smc(fg, key, cfg, shard=shard)
    return SMCResult(fg, xc, xd, log_w, log_z, diag)
