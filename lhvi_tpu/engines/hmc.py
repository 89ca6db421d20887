"""HMC-within-Gibbs sampler for hybrid MRFs.

New capability mandated by BASELINE.json's north-star (the reference has no
sampler of this family): continuous latents move by Hamiltonian Monte Carlo
(leapfrog + Metropolis correction, dual-averaging step-size adaptation,
diagonal mass-matrix adaptation); discrete latents move by chromatic
parallel Gibbs using the compiler's precomputed conflict coloring
(``CompiledFG.color_of``) — all colors' conditionals are evaluated as one
batched pass per color, so a sweep costs ``n_colors`` fused bucket
evaluations regardless of variable count.

Everything is one ``lax.scan`` under ``jit``; chains are a leading axis
(vmapped), ready to be sharded over a mesh ``chains`` axis by
``lhvi_tpu.parallel``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from lhvi_tpu.utils import struct

from lhvi_tpu.fg.compile import CompiledFG, expand_params
from lhvi_tpu.ops.select import select_last

Array = jax.Array
_NEG_BIG = -1e30


@struct.dataclass
class HMCConfig:
    n_leapfrog: int = struct.field(pytree_node=False, default=8)
    init_step_size: float = struct.field(pytree_node=False, default=0.1)
    target_accept: float = struct.field(pytree_node=False, default=0.8)
    gibbs_sweeps: int = struct.field(pytree_node=False, default=1)
    gibbs_max_colors: int = struct.field(pytree_node=False, default=0)
    adapt_mass: bool = struct.field(pytree_node=False, default=True)
    jitter: float = struct.field(pytree_node=False, default=1.0)
    # unroll factor for the per-color planned-Gibbs scan: sweeps over
    # many small color classes (e.g. 288 at pod scale) are loop-latency
    # bound, not FLOP bound — unrolling trades program size for fewer
    # sequential while-loop iterations
    gibbs_unroll: int = struct.field(pytree_node=False, default=1)
    # chain-axis NamedSharding, stamped by run_hmc(shard=...); routes the
    # dense quad leapfrog kernel through shard_map (one kernel per device)
    shard: object = struct.field(pytree_node=False, default=None)
    # sparse targets whose ELL offsets form a small static set take the
    # banded (DIA) shift-multiply-accumulate leapfrog (ops/dia.py); False
    # keeps the ELL gather·FMA path. Both are plain XLA.
    dia_kernel: bool = struct.field(pytree_node=False, default=True)
    # orbit-level mode-swap MH move after each Gibbs stage
    # (engines/modeswap.py): unlocks symmetric joint modes that
    # single-site chromatic Gibbs cannot cross (the pod flagship's
    # frozen ferromagnetic smokes clique).
    # run_hmc/run_nuts build the orbit plan on demand when enabled.
    mode_swap: bool = struct.field(pytree_node=False, default=False)
    # apply the move with probability 1/every per transition (random-scan
    # mixture — exact; amortizes the two logit passes behind a lax.cond)
    mode_swap_every: int = struct.field(pytree_node=False, default=1)


class HMCState(NamedTuple):
    xc: Array  # [C, n_cont]
    xd: Array  # [C, n_disc]
    log_eps: Array  # dual-averaging state (scalars)
    log_eps_bar: Array
    h_bar: Array
    t: Array
    welford_mean: Array  # [n_cont]
    welford_m2: Array
    welford_n: Array
    inv_mass: Array  # [n_cont] diagonal
    # mode-swap move acceptance accumulators (scalars; stay 0 when the
    # move is off) — ride the checkpoint payload so the production
    # convergence evidence survives preemption (resumable fmt 4)
    ms_acc_sum: Array
    ms_acc_n: Array


def _leapfrog(logp, xc, p, eps, inv_mass, n_steps):
    """Standard leapfrog integrator; logp is log π(xc) for fixed xd."""
    grad = jax.grad(logp)

    def body(_, carry):
        x, m = carry
        m = m + 0.5 * eps * grad(x)
        x = x + eps * inv_mass * m
        m = m + 0.5 * eps * grad(x)
        return (x, m)

    return jax.lax.fori_loop(0, n_steps, body, (xc, p))


def gibbs_sweep(fg: CompiledFG, key: Array, xc: Array, xd: Array,
                max_colors: int = 0) -> Array:
    """Chromatic-Gibbs sweep over the discrete latents of one chain.

    ``max_colors > 0`` processes only that many color classes per sweep,
    starting at a random rotation — a random-scan Gibbs kernel that caps
    the per-iteration cost on graphs whose conflict graph needs many
    colors (dense MLNs can need O(n) of them) while every variable is
    still updated with its exact full conditional when its color comes up.
    """
    if fg.n_disc == 0:
        return xd

    def color_step(xd, inp):
        k, c = inp
        logits = fg.disc_logits(xc, xd)  # [n_disc, V]
        new = jax.random.categorical(k, logits, axis=-1).astype(jnp.int32)
        xd = jnp.where(fg.color_of == c, new, xd)
        return xd, None

    n = fg.n_colors
    if 0 < max_colors < n:
        k_rot, key = jax.random.split(key)
        off = jax.random.randint(k_rot, (), 0, n)
        n = max_colors
    else:
        off = jnp.zeros((), jnp.int32)
    colors = (jnp.arange(n, dtype=jnp.int32) + off) % fg.n_colors
    keys = jax.random.split(key, n)
    xd, _ = jax.lax.scan(color_step, xd, (keys, colors))
    return xd


def state_values(fg: CompiledFG, xd: Array) -> Array:
    """Map a discrete index state [n_disc] to domain VALUES [n_disc]
    (one-hot multiply-add over the per-var value table; V is tiny)."""
    if fg.n_disc == 0:
        return jnp.zeros((0,))
    out = jnp.zeros(xd.shape)
    for v in range(fg.max_v):
        out = out + jnp.where(xd == v, fg.disc_vals[..., v], 0.0)
    return out


def _color_class_logits(fg: CompiledFG, grp, tabs, xc, xd, xv):
    """Full-conditional logits ``[M, V]`` for one color class of a
    ``GibbsColorPlan`` group; ``tabs`` are the group's tables sliced at
    one color (leading [nc] axis removed); ``xv`` is the maintained
    value state ``state_values(fg, xd)``.

    Value lookups are all in value space via compile-time tables
    (``disc_cval``/``sub_vals``) + the maintained value state: a runtime
    ``take_along_axis`` over the [R, ad, K] value tables materializes a
    padded copy of the candidate index tensor per color step.
    """
    V = fg.max_v
    M = grp.n_vars
    logits = jnp.zeros((M, V))
    cand = jnp.arange(V, dtype=jnp.int32)
    for b, t in zip(fg.buckets, tabs):
        if t is None:
            continue
        R, ad = t["disc_idx"].shape
        xcs = jnp.where(
            t["cont_mask"] > 0,
            xc[t["cont_idx"]] if xc.shape[0] else jnp.zeros_like(t["cont_const"]),
            t["cont_const"],
        )  # [R, ac]
        lat = t["disc_mask"] > 0
        # values-as-indices fast path (tables dropped at plan build)
        cval = (t["disc_const"].astype(jnp.float32)
                if t["disc_cval"] is None else t["disc_cval"])
        if xd.shape[0]:
            xdi = jnp.where(lat, xd[t["disc_idx"]], t["disc_const"])
            # xv=None: all latent values ARE their indices (plan flag) —
            # no value state exists, derive from the index gather
            xdv = (jnp.where(lat, xdi.astype(jnp.float32), cval)
                   if xv is None
                   else jnp.where(lat, xv[t["disc_idx"]], cval))
        else:
            xdi = t["disc_const"]
            xdv = cval
        sub = t["sub"][:, None, :]
        xdi_p = jnp.where(
            sub, cand[None, :, None],
            jnp.broadcast_to(xdi[:, None, :], (R, V, ad)),
        )  # [R, V, ad] — all slots of the target var move jointly
        sub_vals = (cand.astype(jnp.float32)[None, :]
                    if t["sub_vals"] is None else t["sub_vals"])
        xdv_p = jnp.where(
            sub, sub_vals[:, :, None],
            jnp.broadcast_to(xdv[:, None, :], (R, V, ad)),
        )
        lp = b.kernel(
            expand_params(t["params"], 1), xcs[:, None, :], xdi_p, xdv_p
        )  # [R, V]
        contrib = jnp.nan_to_num(lp, neginf=_NEG_BIG) * t["w"][:, None]
        # scatter-free per-var reduction: vidx [M, D] indexes this color's
        # rows (R = appended zero row)
        contrib = jnp.concatenate([contrib, jnp.zeros((1, V))], axis=0)
        logits = logits + jnp.sum(contrib[t["vidx"]], axis=1)
    return logits


def gibbs_sweep_planned(fg: CompiledFG, key: Array, xc: Array,
                        xd: Array, beta=1.0, unroll: int = 1) -> Array:
    """One FULL exact chromatic sweep via the compile-time color plan.

    Each scan step evaluates only the factor rows adjacent to that color's
    variables (pre-gathered tables), so a full sweep costs O(Σ_v deg(v))
    kernel rows — vs O(n_colors · n_factors) for the all-rows path. Colors
    of similar cost share a scan (uniform padding); updating a subset of a
    color class at a time is still valid parallel Gibbs (subsets of
    independent sets are independent).
    """
    if fg.n_disc == 0:
        return xd
    # unroll < 1 would reach lax.scan's unroll argument and fail with an
    # obscure scan error far from the config — clamp here (single choke
    # point for every caller: HMC, NUTS, SMC rejuvenation)
    unroll = max(1, int(unroll))
    V = fg.max_v
    # value state is only carried when some latent domain's values differ
    # from its indices; the common MLN case carries indices alone (plan
    # flag values_are_indices — no second scatter per color step)
    vai = fg.color_plan.values_are_indices
    xv = None if vai else state_values(fg, xd)
    for gi, grp in enumerate(fg.color_plan.groups):
        gkey = jax.random.fold_in(key, gi)
        keys = jax.random.split(gkey, grp.n_colors)

        def step(carry, s, grp=grp):
            xd, xv = carry
            logits = _color_class_logits(fg, grp, s["tabs"], xc, xd, xv)
            valid = (
                jnp.arange(V, dtype=jnp.int32)[None, :] < s["sizes"][:, None]
            )
            logits = jnp.where(valid, beta * logits, _NEG_BIG)
            new = jax.random.categorical(s["key"], logits, axis=-1).astype(
                jnp.int32
            )
            # padded var slots carry id n_disc -> dropped by the scatter
            xd = xd.at[s["vars"]].set(new, mode="drop")
            if xv is not None:
                # the sampled indices' domain values, via the class value
                # table (one-hot multiply-add — V is tiny and static)
                nv = jnp.zeros(new.shape)
                for v in range(V):
                    nv = nv + jnp.where(new == v, s["vals"][:, v], 0.0)
                xv = xv.at[s["vars"]].set(nv, mode="drop")
            return (xd, xv), None

        xs = {
            "key": keys,
            "vars": grp.vars_,
            "sizes": grp.sizes,
            "vals": None if vai else grp.vals_,
            "tabs": grp.bucket_tabs,
        }
        (xd, xv), _ = jax.lax.scan(step, (xd, xv), xs,
                                   unroll=min(unroll, grp.n_colors))
    return xd


def planned_logits(fg: CompiledFG, xc: Array, xd: Array) -> Array:
    """Assemble ``disc_logits``-shaped ``[n_disc, V]`` logits from the
    color plan at a FIXED state (no sequential updates).

    Scans the per-color tables exactly like ``gibbs_sweep_planned`` (one
    program per cost-group, per-color peak memory ~ that color's adjacent
    rows), so it stays compilable — and vmappable over a chain axis —
    at pod scale, where the all-rows ``disc_logits`` pass materializes
    candidate tensors too large for device memory (the mode-swap move's
    logit backend). Also the exact-identity hook used by
    tests to prove the plan matches ``CompiledFG.disc_logits``."""
    V = fg.max_v
    out = jnp.zeros((fg.n_disc + 1, V))
    xv = (None if fg.color_plan.values_are_indices
          else state_values(fg, xd))
    for grp in fg.color_plan.groups:

        def step(out, s, grp=grp):
            lg = _color_class_logits(fg, grp, s["tabs"], xc, xd, xv)
            out = out.at[s["vars"]].set(lg, mode="drop")
            return out, None

        xs = {"vars": grp.vars_, "tabs": grp.bucket_tabs}
        out, _ = jax.lax.scan(step, out, xs)
    out = out[: fg.n_disc]
    valid = (
        jnp.arange(V, dtype=jnp.int32)[None, :] < fg.disc_sizes[:, None]
    )
    return jnp.where(valid, out, _NEG_BIG)


class _StreamDiag(NamedTuple):
    """Per-chain streaming accumulators for convergence diagnostics in
    ``collect="moments"`` mode (SURVEY.md §6 metrics plan: R̂/ESS must be
    available exactly where runs are too big to materialize samples).

    Carries two per-chain Welford pairs (first/second half of the draw
    window — the two "split" chains of split-R̂), a lag-1 cross-product
    for an AR(1) ESS proxy, and a batch-means block (current-batch sum +
    a Welford pair over completed batch means) for a streamed batch-means
    ESS that, unlike the AR(1) proxy, is sensitive to ALL lags up to the
    batch length. All [C, n_cont]. Full-window moments are derived at
    finalize by Chan-merging the two halves; each step updates ONE half's
    pair (``lax.cond`` on the scalar draw index), and the batch-means
    Welford pair is touched only at batch boundaries — per-draw HBM
    traffic is ~6 [C, n] round-trips, not the 17 of the naive
    formulation."""

    h1_mean: Array
    h1_m2: Array
    h2_mean: Array
    h2_m2: Array
    cross: Array
    prev: Array
    bm_cur: Array   # running sum of the current batch
    bm_mean: Array  # Welford over completed batch MEANS
    bm_m2: Array


def _stream_diag_init(C: int, n: int) -> _StreamDiag:
    z = jnp.zeros((C, n))
    return _StreamDiag(z, z, z, z, z, z, z, z, z)


def _split_welford_update(h1_mean, h1_m2, h2_mean, h2_m2, tf, x, half: int):
    """Fold draw ``tf`` (0-based, traced scalar) into the split-half
    Welford pairs (shared by the continuous and discrete streams)."""

    def welford(mean, m2, cnt_new):
        delta = x - mean
        mean2 = mean + delta / jnp.maximum(cnt_new, 1.0)
        return mean2, m2 + delta * (x - mean2)

    def upd1(_):
        m, s = welford(h1_mean, h1_m2, tf + 1.0)
        return m, s, h2_mean, h2_m2

    def upd2(_):
        m, s = welford(h2_mean, h2_m2, tf + 1.0 - half)
        return h1_mean, h1_m2, m, s

    def noop(_):  # odd-S tail draw: belongs to neither split half
        return h1_mean, h1_m2, h2_mean, h2_m2

    return jax.lax.cond(
        tf < half, upd1,
        lambda o: jax.lax.cond(tf < 2.0 * half, upd2, noop, o),
        None,
    )


def _stream_diag_update(sd: _StreamDiag, t, xc: Array, half: int,
                        bm_len: int = 0, n_batches: int = 0) -> _StreamDiag:
    """Fold draw ``t`` (0-based) of every chain into the accumulators.

    ``bm_len``/``n_batches`` (static) enable the batch-means stream:
    every ``bm_len`` draws the batch mean is folded into a Welford pair
    and the batch sum reset. ``bm_len=0`` leaves the bm block untouched
    (schema-stable no-op for callers that predate it)."""
    tf = t.astype(xc.dtype)
    h1_mean, h1_m2, h2_mean, h2_m2 = _split_welford_update(
        sd.h1_mean, sd.h1_m2, sd.h2_mean, sd.h2_m2, tf, xc, half
    )
    cross = sd.cross + jnp.where(tf > 0, xc * sd.prev, 0.0)
    bm_cur, bm_mean, bm_m2 = sd.bm_cur, sd.bm_mean, sd.bm_m2
    if bm_len > 0 and n_batches >= 2:
        bm_cur = bm_cur + xc
        t1 = t + 1
        batch_no = t1 // bm_len  # 1-based count AT a boundary

        def fold(ops):
            cur, mean, m2 = ops
            bmean = cur / bm_len
            cnt = batch_no.astype(xc.dtype)
            delta = bmean - mean
            mean2 = mean + delta / jnp.maximum(cnt, 1.0)
            return jnp.zeros_like(cur), mean2, m2 + delta * (bmean - mean2)

        bm_cur, bm_mean, bm_m2 = jax.lax.cond(
            (t1 % bm_len == 0) & (batch_no <= n_batches),
            fold, lambda ops: ops, (bm_cur, bm_mean, bm_m2),
        )
    return _StreamDiag(h1_mean, h1_m2, h2_mean, h2_m2, cross, xc,
                       bm_cur, bm_mean, bm_m2)


def _stream_diag_finalize(sd: _StreamDiag, n_samples: int,
                          bm_len: int = 0) -> dict:
    """{'rhat': [n], 'ess_proxy': [n], 'ess_bm': [n]} from the streamed
    accumulators.

    ``rhat`` is EXACT split-R̂ (identical to ``utils.diagnostics.split_rhat``
    on the materialized [S, C, n] samples — the per-half Welford pairs are
    the same chain means/variances). ``ess_proxy`` is the AR(1)
    approximation S·C·(1−ρ̂₁)/(1+ρ̂₁) from the pooled lag-1 autocorrelation —
    cheap but blind to higher-lag structure. ``ess_bm`` is the batch-means
    estimator: per chain, τ̂ = b·s²_bm/s² (variance of the ⌊S/b⌋ batch
    means over the full-window variance), ESS = Σ_c min(S/τ̂_c, S) — it
    integrates autocorrelation up to the batch length b=⌊√S⌋, so it is
    the more defensible production number when chains mix slower than one
    lag (accuracy envelope vs Geyer measured in tests/test_stream_diag.py).
    NaN when ``bm_len`` was 0 (fewer than 2 complete batches). The
    per-chain full-window moments are Chan-merged from the two half
    pairs (equal counts), not carried separately."""
    C, n = sd.h1_mean.shape
    half = n_samples // 2
    if half < 2:
        nanv = jnp.full((n,), jnp.nan)
        return {"rhat": nanv, "ess_proxy": nanv, "ess_bm": nanv}
    chain_mean = jnp.concatenate([sd.h1_mean, sd.h2_mean], axis=0)
    chain_var = jnp.concatenate([sd.h1_m2, sd.h2_m2], axis=0) / (half - 1)
    B = half * jnp.var(chain_mean, axis=0, ddof=1)
    W = jnp.mean(chain_var, axis=0)
    var_hat = (half - 1) / half * W + B / half
    rhat = jnp.sqrt(var_hat / jnp.maximum(W, 1e-12))
    S = n_samples
    # Chan merge of the equal-count halves → per-chain moments over the
    # 2·half window (the odd tail draw, if any, is excluded here but
    # included in `cross` — an O(1/S) wobble well inside proxy accuracy)
    f_mean = 0.5 * (sd.h1_mean + sd.h2_mean)
    f_m2 = sd.h1_m2 + sd.h2_m2 + 0.5 * half * (sd.h1_mean - sd.h2_mean) ** 2
    var_c = f_m2 / max(2 * half - 1, 1)
    rho1 = (sd.cross / max(S - 1, 1) - f_mean * f_mean) / jnp.maximum(
        var_c, 1e-12
    )
    rho1 = jnp.clip(jnp.mean(rho1, axis=0), 0.0, 0.999)
    ess = S * C * (1.0 - rho1) / (1.0 + rho1)
    n_batches = S // bm_len if bm_len else 0
    if n_batches >= 2:
        s2_bm = sd.bm_m2 / (n_batches - 1)  # [C, n]
        tau = bm_len * s2_bm / jnp.maximum(var_c, 1e-12)
        ess_c = jnp.minimum(S / jnp.maximum(tau, 1e-12), float(S))
        # a frozen dimension (var_c == 0) has no defined autocorrelation;
        # report S per chain rather than 0/0 noise
        ess_c = jnp.where(var_c <= 0.0, float(S), ess_c)
        ess_bm = jnp.sum(ess_c, axis=0)
    else:
        ess_bm = jnp.full((n,), jnp.nan)
    return {"rhat": rhat, "ess_proxy": ess, "ess_bm": ess_bm}


class _StreamDiagDisc(NamedTuple):
    """Split-half Welford pairs over the VALUE states of (a subset of)
    the discrete latents — the streamed split-R̂ evidence for the Gibbs
    half of the sampler. All
    [C, n_sel] f32, where the selection is every discrete latent below
    ``disc_diag_cap`` and a deterministic color-stratified subsample
    above it (``disc_diag_select``)."""

    h1_mean: Array
    h1_m2: Array
    h2_mean: Array
    h2_m2: Array


def _stream_diag_disc_init(C: int, n_sel: int) -> _StreamDiagDisc:
    z = jnp.zeros((C, n_sel))
    return _StreamDiagDisc(z, z, z, z)


def disc_diag_select(fg: CompiledFG, cap: int, seed: int = 0):
    """Deterministic selection of discrete variables for streamed
    convergence diagnostics (host-side, baked into the jitted program).

    All ``n_disc`` variables when ``n_disc <= cap``; otherwise a
    subsample of size ``cap`` stratified over the chromatic-Gibbs color
    classes (``fg.color_of``) by largest-remainder proportional
    allocation (≥1 per class while the budget allows — classes are the
    structural symmetry groups, so stratifying by them covers every
    update pattern the sweep has). Keyed by ``seed``: the same model +
    cap + seed always monitors the same variables."""
    n = fg.n_disc
    if n <= cap:
        return np.arange(n, dtype=np.int32)
    colors = np.asarray(fg.color_of)
    rng = np.random.default_rng(seed)
    uniq, counts = np.unique(colors, return_counts=True)
    quota = np.floor(cap * counts / n).astype(np.int64)
    if len(uniq) <= cap:
        quota = np.maximum(quota, 1)
    # largest-remainder top-up / trim to exactly cap
    rem = cap * counts / n - np.floor(cap * counts / n)
    while quota.sum() < cap:
        i = int(np.argmax(rem))
        quota[i] += 1
        rem[i] = -1.0
    while quota.sum() > cap:
        i = int(np.argmax(quota))
        quota[i] -= 1
    sel = []
    for c, q in zip(uniq, quota):
        if q <= 0:
            continue
        idx = np.flatnonzero(colors == c)
        sel.append(rng.choice(idx, size=min(int(q), idx.size),
                              replace=False))
    return np.sort(np.concatenate(sel)).astype(np.int32)


def _disc_sel_values(fg: CompiledFG, sel, xd: Array) -> Array:
    """[C, n_sel] f32 domain VALUES of the selected discrete latents —
    matches what ``split_rhat`` on a materialized value trace sees (the
    one-hot multiply-add over the per-var value table; V is tiny)."""
    xs = xd[:, sel]
    vals = fg.disc_vals[sel]  # [n_sel, V]
    out = jnp.zeros(xs.shape)
    for v in range(fg.max_v):
        out = out + jnp.where(xs == v, vals[None, :, v], 0.0)
    return out


def _stream_diag_disc_update(sdd: _StreamDiagDisc, t, xv: Array,
                             half: int) -> _StreamDiagDisc:
    """Fold draw ``t``'s selected discrete VALUES into the accumulators."""
    tf = t.astype(xv.dtype)
    return _StreamDiagDisc(*_split_welford_update(
        sdd.h1_mean, sdd.h1_m2, sdd.h2_mean, sdd.h2_m2, tf, xv, half
    ))


def _stream_diag_disc_finalize(sdd: _StreamDiagDisc,
                               n_samples: int) -> dict:
    """{'rhat_disc': [n_sel]} — exact split-R̂ over the selected discrete
    latents' value traces. A latent frozen at ONE value across all chains
    and halves (B = W = 0, e.g. symmetry-pinned by evidence) reports 1.0
    — "no disagreement" — rather than the 0/0 artifact; B > 0 with W = 0
    (chains stuck at DIFFERENT values) still blows up, which is the
    signal the statistic exists for."""
    half = n_samples // 2
    n = sdd.h1_mean.shape[1]
    if half < 2:
        return {"rhat_disc": jnp.full((n,), jnp.nan)}
    chain_mean = jnp.concatenate([sdd.h1_mean, sdd.h2_mean], axis=0)
    chain_var = jnp.concatenate([sdd.h1_m2, sdd.h2_m2], axis=0) / (half - 1)
    B = half * jnp.var(chain_mean, axis=0, ddof=1)
    W = jnp.mean(chain_var, axis=0)
    var_hat = (half - 1) / half * W + B / half
    rhat = jnp.sqrt(var_hat / jnp.maximum(W, 1e-12))
    return {"rhat_disc": jnp.where((W <= 0.0) & (B <= 1e-12), 1.0, rhat)}


def _bm_schedule(n_samples: int) -> tuple:
    """Static (batch length, batch count) for the batch-means stream:
    b = ⌊√S⌋ balances bias (short batches miss long-lag correlation)
    against variance (few batches); disabled (0, 0) when fewer than two
    complete batches fit."""
    b = max(1, int(n_samples ** 0.5))
    nb = n_samples // b
    return (b, nb) if nb >= 2 else (0, 0)


def _hmc_step_batched(fg: CompiledFG, cfg: HMCConfig, key, xc, xd, eps,
                      inv_mass):
    """One HMC proposal for ALL chains at once.

    On purely-quadratic continuous targets this routes through the fused
    quad leapfrog (``ops.leapfrog``: Triton kernel on the GPU for small
    dense J, XLA otherwise; ELL/DIA for sparse J); otherwise all chains
    run one LOCKSTEP batched leapfrog driven by
    ``∇ log_prob_cont_batched`` — one fused gather/kernel program per
    bucket for the whole batch, and the purely-discrete buckets (constant
    in xc at the chain's fixed xd, e.g. the pod-scale MLN cliques) drop
    out of the Hamiltonian exactly (they cancel in the MH ratio and have
    zero xc-gradient).
    """
    if not fg.cont_pure_quad:
        from lhvi_tpu.ops.logpot import logpot_leapfrog

        C = xc.shape[0]
        k_mom, k_acc = jax.random.split(key)
        std = jnp.sqrt(1.0 / jnp.maximum(inv_mass, 1e-12))
        p0 = std[None, :] * jax.random.normal(k_mom, xc.shape)
        # fused-by-XLA batched leapfrog; the trajectory energies come
        # back with the endpoint
        x1, p1, lp0, lp1 = logpot_leapfrog(
            fg, xc, p0, xd, inv_mass, eps, cfg.n_leapfrog,
        )
        ke = lambda p: 0.5 * jnp.sum(inv_mass[None, :] * p * p, axis=-1)
        h0 = -lp0 + ke(p0)
        h1 = -lp1 + ke(p1)
        log_acc = jnp.minimum(0.0, h0 - h1)
        log_acc = jnp.where(jnp.isfinite(log_acc), log_acc, -jnp.inf)
        accept = jnp.log(jax.random.uniform(k_acc, (C,))) < log_acc
        xc = jnp.where(accept[:, None], x1, xc)
        return xc, jnp.exp(log_acc)

    from lhvi_tpu.ops.leapfrog import ell_quad_leapfrog, quad_leapfrog

    C = xc.shape[0]
    k_mom, k_acc = jax.random.split(key)

    if (fg.quad_sparse and fg.quad_dia_offsets is not None
            and cfg.dia_kernel):
        # banded refinement: one proposal — momentum sampling, static
        # shift-multiply-accumulate integration (no gathers), energies —
        # all in declaration-order embedded coordinates, entered/left by
        # ONE gather each way (ops/dia.py)
        from lhvi_tpu.ops.dia import dia_hmc_proposal

        x1, log_acc = dia_hmc_proposal(
            k_mom, xc, fg.quad_diag, fg.quad_dia_offsets, fg.quad_dia_w,
            fg.quad_h, inv_mass, eps, cfg.n_leapfrog,
            pos=fg.quad_dia_pos, inv=fg.quad_dia_inv,
        )
        accept = jnp.log(jax.random.uniform(k_acc, (C,))) < log_acc
        xc = jnp.where(accept[:, None], x1, xc)
        return xc, jnp.exp(log_acc)

    std = jnp.sqrt(1.0 / jnp.maximum(inv_mass, 1e-12))
    p0 = std[None, :] * jax.random.normal(k_mom, xc.shape)
    ke = lambda p: 0.5 * jnp.sum(inv_mass[None, :] * p * p, axis=-1)
    if fg.quad_sparse:
        # ELL fused path (n_cont beyond the dense cap): pure-XLA batched
        # leapfrog on the gather·multiply·sum matvec — GSPMD partitions
        # it natively on a sharded chain axis (no shard_map needed). The
        # endpoint gradients come back free: lp = c + ½·x·(h + g), so
        # the accept step costs no extra matvecs.
        x1, p1, g0, g1 = ell_quad_leapfrog(
            xc, p0, fg.quad_diag, fg.quad_ell_col, fg.quad_ell_w,
            fg.quad_h, inv_mass, eps, cfg.n_leapfrog,
        )
        hq = fg.quad_h[None, :]
        lp0 = fg.quad_c + 0.5 * jnp.sum(xc * (hq + g0), axis=-1)
        lp1 = fg.quad_c + 0.5 * jnp.sum(x1 * (hq + g1), axis=-1)
        h0 = -lp0 + ke(p0)
        h1 = -lp1 + ke(p1)
    else:
        x1, p1 = quad_leapfrog(
            xc, p0, fg.quad_J, fg.quad_h, inv_mass, eps, cfg.n_leapfrog,
            shard=cfg.shard,
        )
        h0 = -fg.quad_log_prob_batched(xc) + ke(p0)
        h1 = -fg.quad_log_prob_batched(x1) + ke(p1)
    log_acc = jnp.minimum(0.0, h0 - h1)
    log_acc = jnp.where(jnp.isfinite(log_acc), log_acc, -jnp.inf)
    accept = jnp.log(jax.random.uniform(k_acc, (C,))) < log_acc
    xc = jnp.where(accept[:, None], x1, xc)
    return xc, jnp.exp(log_acc)


def sweep_all(fg: CompiledFG, cfg: HMCConfig, key, xc, xd):
    """cfg.gibbs_sweeps chromatic sweeps over all chains.

    Uses the compile-time per-color plan (full exact sweeps at
    O(Σ deg) cost) when available; ``gibbs_max_colors > 0`` keeps the
    legacy rotated all-rows path (random-scan with capped per-iteration
    cost — mostly obsolete now that full planned sweeps are cheaper than
    one rotated legacy step).
    """
    planned = fg.color_plan is not None and cfg.gibbs_max_colors == 0
    for _ in range(cfg.gibbs_sweeps):
        keys = jax.random.split(key, xc.shape[0] + 1)
        key = keys[0]
        if planned:
            xd = jax.vmap(
                lambda k, a, b: gibbs_sweep_planned(
                    fg, k, a, b, unroll=cfg.gibbs_unroll)
            )(keys[1:], xc, xd)
        else:
            xd = jax.vmap(
                lambda k, a, b: gibbs_sweep(fg, k, a, b, cfg.gibbs_max_colors)
            )(keys[1:], xc, xd)
    return xd


def hmc_transition(fg: CompiledFG, cfg: HMCConfig, state: HMCState, key,
                   adapt: bool):
    """One full HMC-within-Gibbs transition for all chains; the unit the
    run/warmup scans and the checkpointed driver are built from."""
    k_g, k_h, k_ms = jax.random.split(key, 3)
    xd = sweep_all(fg, cfg, k_g, state.xc, state.xd)
    if cfg.mode_swap and fg.mode_swap_plan is not None:
        from lhvi_tpu.engines.modeswap import maybe_mode_swap

        xd, ms_acc, n_inc = maybe_mode_swap(fg, cfg, k_ms, state.xc, xd)
        state = state._replace(ms_acc_sum=state.ms_acc_sum + ms_acc,
                               ms_acc_n=state.ms_acc_n + n_inc)
    eps = jnp.exp(state.log_eps)
    xc, acc = _hmc_step_batched(fg, cfg, k_h, state.xc, xd, eps,
                                state.inv_mass)
    state = state._replace(xc=xc, xd=xd)
    if adapt:
        state = _da_update(state, jnp.mean(acc), cfg)
        state = _welford_update(state, xc)
    return state, acc


def init_hmc_state(fg: CompiledFG, key, cfg: HMCConfig, n_chains: int,
                   shard=None) -> HMCState:
    """Fresh batched sampler state (pre-warmup)."""
    xc, xd = fg.init_state_batched(key, n_chains, cfg.jitter)
    if shard is not None:
        xc = jax.lax.with_sharding_constraint(xc, shard)
        xd = jax.lax.with_sharding_constraint(xd, shard)
    return HMCState(
        xc=xc, xd=xd,
        log_eps=jnp.log(jnp.asarray(cfg.init_step_size)),
        log_eps_bar=jnp.log(jnp.asarray(cfg.init_step_size)),
        h_bar=jnp.zeros(()), t=jnp.zeros(()),
        welford_mean=jnp.zeros(fg.n_cont),
        welford_m2=jnp.zeros(fg.n_cont),
        welford_n=jnp.zeros(()),
        inv_mass=jnp.ones(fg.n_cont),
        ms_acc_sum=jnp.zeros(()),
        ms_acc_n=jnp.zeros(()),
    )


def _mass_refresh(fg: CompiledFG, cfg, state: HMCState) -> HMCState:
    if not cfg.adapt_mass or fg.n_cont == 0:
        return state
    var = state.welford_m2 / jnp.maximum(state.welford_n - 1.0, 1.0)
    inv_mass = jnp.where(state.welford_n > 10.0, jnp.maximum(var, 1e-6), 1.0)
    return state._replace(inv_mass=inv_mass)


def run_warmup(fg: CompiledFG, cfg, state: HMCState, k_warm, n_warmup: int,
               transition):
    """Two-phase warmup (dual-averaging; mass refresh between phases).
    ``transition(state, key, adapt) -> (state, acc)`` — HMC or NUTS.
    """
    if n_warmup <= 0:
        return state

    def warm_step(state, key):
        state, acc = transition(state, key, True)
        return state, jnp.mean(acc)

    half = max(n_warmup // 2, 1)
    state, _ = jax.lax.scan(warm_step, state, jax.random.split(k_warm, half))
    state = _mass_refresh(fg, cfg, state)
    state = state._replace(
        h_bar=jnp.zeros(()), t=jnp.zeros(()),
        welford_mean=jnp.zeros(fg.n_cont),
        welford_m2=jnp.zeros(fg.n_cont), welford_n=jnp.zeros(()),
    )
    state, _ = jax.lax.scan(
        warm_step, state,
        jax.random.split(jax.random.fold_in(k_warm, 1), n_warmup - half),
    )
    state = _mass_refresh(fg, cfg, state)
    return state._replace(log_eps=state.log_eps_bar)


def _da_update(state: HMCState, accept_mean, cfg: HMCConfig):
    """Nesterov dual averaging on log step size (Hoffman–Gelman 2014)."""
    gamma, t0, kappa = 0.05, 10.0, 0.75
    mu = jnp.log(10.0 * cfg.init_step_size)
    t = state.t + 1.0
    h_bar = (1.0 - 1.0 / (t + t0)) * state.h_bar + (
        cfg.target_accept - accept_mean
    ) / (t + t0)
    log_eps = mu - jnp.sqrt(t) / gamma * h_bar
    w = t ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * state.log_eps_bar
    return state._replace(
        log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, t=t
    )


def _welford_update(state: HMCState, xc):
    """Chan et al. batched Welford: fold all C chain states in at once (the
    estimand is the cross-chain posterior variance, not the chain-mean's)."""
    C = xc.shape[0]
    n_new = state.welford_n + C
    batch_mean = jnp.mean(xc, axis=0)
    batch_m2 = jnp.sum((xc - batch_mean) ** 2, axis=0)
    delta = batch_mean - state.welford_mean
    mean = state.welford_mean + delta * (C / n_new)
    m2 = state.welford_m2 + batch_m2 + delta**2 * (state.welford_n * C / n_new)
    return state._replace(welford_mean=mean, welford_m2=m2, welford_n=n_new)


def _ensure_mode_swap_plan(fg: CompiledFG, cfg):
    """Attach the orbit mode-swap plan when the move is enabled (host-side,
    one-time per model — the refinement is the same pass ``fast_lift``
    runs). Falls back to the plain sweep, with a warning, on models whose
    refinement leaves no multi-member class."""
    if not getattr(cfg, "mode_swap", False) or fg.mode_swap_plan is not None:
        return fg, cfg
    from lhvi_tpu.engines.modeswap import plan_for

    plan = plan_for(fg)
    if plan is None:
        import warnings

        warnings.warn(
            "mode_swap=True but color refinement found no discrete class "
            "with >=2 members — the move is a no-op on this model; "
            "running plain chromatic Gibbs.", stacklevel=3,
        )
        return fg, cfg.replace(mode_swap=False)
    return fg.replace(mode_swap_plan=plan), cfg


def run_hmc(
    fg: CompiledFG,
    key: Array,
    cfg: HMCConfig = HMCConfig(),
    n_chains: int = 8,
    n_warmup: int = 500,
    n_samples: int = 1000,
    thin: int = 1,
    collect: str = "samples",
    shard=None,
    stream_diag: bool = True,
    disc_diag_cap: int = 4096,
):
    """Run the sampler.

    collect="samples": returns (samples_xc [S,C,n_cont], samples_xd
    [S,C,n_disc], diag). collect="moments": streams sufficient statistics
    on-device instead of materializing the sample array (the production
    mode for large runs — avoids S·C·n HBM traffic and host transfer);
    returns (moments dict, None, diag).

    shard: optional ``NamedSharding`` for the chains axis (e.g. from
    ``lhvi_tpu.parallel.chain_sharding``) — the whole scan then runs with
    chain state distributed over the mesh; reductions (mean accept,
    Welford, streamed moments) become cross-device collectives inserted
    by XLA.

    stream_diag (moments mode): carry the streamed split-R̂/ESS
    accumulators (default — production runs want convergence evidence).
    Set False for pure-throughput measurement: the accumulators cost
    ~5 [C, n] HBM round-trips per draw.

    disc_diag_cap (moments mode, with stream_diag): how many discrete
    latents carry streamed split-R̂ over their value traces
    (diag["rhat_disc"], with diag["disc_diag_idx"] naming the monitored
    variables). All of them below the cap; a deterministic
    color-stratified subsample of exactly ``cap`` above it
    (``disc_diag_select``). 0 disables the discrete stream.
    """
    # the selection reads fg.color_of with host numpy — hoisted out of
    # the jitted body (where fg's arrays are tracers) and passed as a
    # static tuple
    want_disc = (collect == "moments" and stream_diag and fg.n_disc > 0
                 and disc_diag_cap > 0)
    disc_sel = (tuple(int(i) for i in disc_diag_select(fg, disc_diag_cap))
                if want_disc else None)
    fg, cfg = _ensure_mode_swap_plan(fg, cfg)
    return _run_hmc(fg, key, cfg, n_chains=n_chains, n_warmup=n_warmup,
                    n_samples=n_samples, thin=thin, collect=collect,
                    shard=shard, stream_diag=stream_diag,
                    disc_sel=disc_sel)


@partial(jax.jit, static_argnames=("n_chains", "n_warmup", "n_samples",
                                   "thin", "collect", "shard",
                                   "stream_diag", "disc_sel"))
def _run_hmc(
    fg: CompiledFG,
    key: Array,
    cfg: HMCConfig,
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
    if shard is not None:
        # the quad leapfrog kernel dispatches per-shard via shard_map
        # (chains never communicate inside a transition)
        cfg = cfg.replace(shard=shard)
    state = init_hmc_state(fg, k_init, cfg, n_chains, shard)
    trans = lambda s, k, adapt: hmc_transition(fg, cfg, s, k, adapt)
    state = run_warmup(fg, cfg, state, k_warm, n_warmup, trans)
    # mode-swap acceptance is reported for the SAMPLING window only (like
    # accept_rate): drop the warmup-phase accumulation
    state = state._replace(ms_acc_sum=jnp.zeros(()), ms_acc_n=jnp.zeros(()))

    def sample_step(state: HMCState, key):
        # thin streams INSIDE the scan step: only every thin-th state is
        # emitted, so the retained array is [n_samples, C, n] — never the
        # un-thinned [n_samples*thin, C, n]
        def inner(t, carry):
            state, _ = carry
            state, acc = trans(state, jax.random.fold_in(key, t), False)
            return state, jnp.mean(acc)

        state, acc = jax.lax.fori_loop(0, thin, inner, (state, 0.0))
        return state, (state.xc, state.xd, acc)

    if collect == "moments":
        half = n_samples // 2
        bm_len, n_batches = _bm_schedule(n_samples)
        want_disc = disc_sel is not None
        sel = np.asarray(disc_sel, np.int32) if want_disc else None

        def moment_step(carry, inp):
            key, t = inp
            state, s1, s2, cnt, sd, sdd = carry
            state, (xc, xd, acc) = sample_step(state, key)
            s1 = s1 + jnp.sum(xc, axis=0)
            s2 = s2 + jnp.sum(xc * xc, axis=0)
            if fg.n_disc:
                oh = jax.nn.one_hot(xd, fg.max_v, dtype=jnp.float32)
                cnt = cnt + jnp.sum(oh, axis=0)
            if stream_diag:
                sd = _stream_diag_update(sd, t, xc, half, bm_len, n_batches)
            if want_disc:
                sdd = _stream_diag_disc_update(
                    sdd, t, _disc_sel_values(fg, sel, xd), half)
            return (state, s1, s2, cnt, sd, sdd), acc

        z1 = jnp.zeros(fg.n_cont)
        z2 = jnp.zeros(fg.n_cont)
        zc = jnp.zeros((max(fg.n_disc, 1), fg.max_v))
        sd0 = (_stream_diag_init(n_chains, fg.n_cont) if stream_diag
               else ())
        sdd0 = (_stream_diag_disc_init(n_chains, len(sel)) if want_disc
                else ())
        (state, s1, s2, cnt, sd, sdd), accs = jax.lax.scan(
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
            "step_size": jnp.exp(state.log_eps),
            "inv_mass": state.inv_mass,
            **({"mode_swap_accept":
                state.ms_acc_sum / jnp.maximum(state.ms_acc_n, 1.0)}
               if cfg.mode_swap else {}),
            **(_stream_diag_finalize(sd, n_samples, bm_len)
               if stream_diag else {}),
            **(_stream_diag_disc_finalize(sdd, n_samples)
               if want_disc else {}),
        }
        if want_disc:
            diag["disc_diag_idx"] = jnp.asarray(sel)
        return moments, None, diag

    state, (s_xc, s_xd, accs) = jax.lax.scan(
        sample_step, state, jax.random.split(k_samp, n_samples)
    )
    diag = {
        "accept_rate": jnp.mean(accs),
        "step_size": jnp.exp(state.log_eps),
        "inv_mass": state.inv_mass,
        **({"mode_swap_accept":
            state.ms_acc_sum / jnp.maximum(state.ms_acc_n, 1.0)}
           if cfg.mode_swap else {}),
    }
    return s_xc, s_xd, diag


class HMCResult:
    """Query wrapper mapping RVs to marginal statistics (reference
    ``belief/map`` query parity, SURVEY.md §2 L3)."""

    def __init__(self, fg: CompiledFG, s_xc, s_xd, diag):
        import numpy as np

        self.fg = fg
        s_xc, s_xd = np.asarray(s_xc), np.asarray(s_xd)
        n_draws = s_xc.shape[0] * s_xc.shape[1]
        self.xc = s_xc.reshape(n_draws, fg.n_cont)  # [S*C, n]
        self.xd = s_xd.reshape(n_draws, fg.n_disc)
        self.diag = {k: np.asarray(v) for k, v in diag.items()}

    def _loc(self, rv, want):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            raise ValueError(f"{rv} is observed (evidence); it has no posterior")
        if kind != want:
            raise ValueError(f"{rv} is {'continuous' if kind=='c' else 'discrete'}")
        return i

    def mean(self, rv) -> float:
        return float(self.xc[:, self._loc(rv, "c")].mean())

    def var(self, rv) -> float:
        return float(self.xc[:, self._loc(rv, "c")].var())

    def disc_marginal(self, rv):
        import numpy as np

        i = self._loc(rv, "d")
        size = self.fg.meta.disc_size(rv)
        counts = np.bincount(self.xd[:, i], minlength=size)[:size]
        return counts / counts.sum()

    def map(self, rv):
        kind, _ = self.fg.meta.loc(rv)
        if kind == "c":
            return float(self.xc[:, self._loc(rv, "c")].mean())
        probs = self.disc_marginal(rv)
        return self.fg.meta.disc_values(rv)[int(probs.argmax())]


class HMCMoments:
    """Query wrapper over streamed sufficient statistics (collect="moments")."""

    def __init__(self, fg: CompiledFG, moments, diag):
        import numpy as np

        self.fg = fg
        self.moments = {k: np.asarray(v) for k, v in moments.items()}
        self.diag = {k: np.asarray(v) for k, v in diag.items()}

    def _loc(self, rv, want):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            raise ValueError(f"{rv} is observed (evidence); it has no posterior")
        if kind != want:
            raise ValueError(f"{rv} is {'continuous' if kind == 'c' else 'discrete'}")
        return i

    def mean(self, rv) -> float:
        return float(self.moments["mean"][self._loc(rv, "c")])

    def var(self, rv) -> float:
        return float(self.moments["var"][self._loc(rv, "c")])

    def disc_marginal(self, rv):
        i = self._loc(rv, "d")
        return self.moments["disc_probs"][i, : self.fg.meta.disc_size(rv)]

    def map(self, rv):
        kind, _ = self.fg.meta.loc(rv)
        if kind == "c":
            return self.mean(rv)
        p = self.disc_marginal(rv)
        return self.fg.meta.disc_values(rv)[int(p.argmax())]


def sample(fg: CompiledFG, key, **kw):
    """Convenience wrapper: run and wrap results for RV-level queries."""
    cfg = kw.pop("cfg", HMCConfig())
    if kw.get("collect") == "moments":
        moments, _, diag = run_hmc(fg, key, cfg, **kw)
        return HMCMoments(fg, moments, diag)
    s_xc, s_xd, diag = run_hmc(fg, key, cfg, **kw)
    return HMCResult(fg, s_xc, s_xd, diag)
