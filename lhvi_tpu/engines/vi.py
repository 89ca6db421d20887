"""Mixture-of-Gaussian variational inference (the reference's "OSI" engine).

Semantics parity with SURVEY.md §4.3 (reference ``OneShot.py``; mount empty,
algorithm reconstructed from the companion paper): the belief is
``b(x) = Σ_k w_k Π_v b_v^k(x_v)`` with Gaussian components for continuous
latents and categoricals for discrete ones; the ELBO is

    ELBO = Σ_f m_f · Σ_k w_k E_{b_k}[log φ_f]  +  H̃(b)

where the factor expectations use Gauss–Hermite quadrature over continuous
slots × enumeration over discrete slots, ``m_f`` is the lifted orbit count
(``FactorBucket.scale``), and ``H̃`` is the Jensen lower bound on mixture
entropy via pairwise component overlaps (per-variable terms weighted by
orbit sizes ``cont_counts``/``disc_counts`` in lifted mode).

Batched redesign vs the reference's TF-session loop: the whole ELBO is one
``value_and_grad`` jit — factor terms batched per bucket with a static
quadrature grid (grid only spans *latent* slots; evidence is baked by the
compiler), optimized with optax Adam under ``lax.scan``. Entropy terms stay
in f32 (SURVEY.md §9 hard part (b)).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
import optax
from lhvi_tpu.utils import struct

from lhvi_tpu.fg.compile import CompiledFG, FactorBucket, expand_params
from lhvi_tpu.ops.select import select_last

Array = jax.Array

_NEG_BIG = -1e30


@struct.dataclass
class VIConfig:
    K: int = struct.field(pytree_node=False, default=4)
    n_quad: int = struct.field(pytree_node=False, default=9)
    lr: float = struct.field(pytree_node=False, default=5e-2)
    n_iters: int = struct.field(pytree_node=False, default=1500)
    init_sigma: float = struct.field(pytree_node=False, default=1.0)
    seed_spread: float = struct.field(pytree_node=False, default=1.0)


class VIParams(NamedTuple):
    log_w: Array  # [K]
    mu: Array  # [K, n_cont]
    log_sigma: Array  # [K, n_cont]
    logits: Array  # [K, n_disc, Vmax]


def init_params(fg: CompiledFG, key: Array, cfg: VIConfig) -> VIParams:
    kmu, kl = jax.random.split(key)
    mid = 0.5 * (fg.cont_lo + fg.cont_hi)
    span = jnp.minimum(fg.cont_hi - fg.cont_lo, 4.0)
    mu = mid + cfg.seed_spread * span[None, :] * 0.25 * jax.random.normal(
        kmu, (cfg.K, fg.n_cont)
    )
    return VIParams(
        log_w=jnp.zeros(cfg.K),
        mu=mu,
        log_sigma=jnp.full((cfg.K, fg.n_cont), jnp.log(cfg.init_sigma)),
        logits=0.1 * jax.random.normal(kl, (cfg.K, fg.n_disc, fg.max_v)),
    )


def _valid_mask(fg: CompiledFG) -> Array:
    """[n_disc, Vmax] 1 where the value index is inside the domain."""
    v = jnp.arange(fg.max_v)[None, :]
    return (v < fg.disc_sizes[:, None]).astype(jnp.float32)


def beliefs_disc(fg: CompiledFG, params: VIParams) -> Array:
    """Masked per-component categorical beliefs [K, n_disc, Vmax]."""
    mask = _valid_mask(fg)[None]
    logits = jnp.where(mask > 0, params.logits, _NEG_BIG)
    return jax.nn.softmax(logits, axis=-1) * mask


def _bucket_grid(b: FactorBucket, n_quad: int, max_v: int):
    """Static quadrature/enumeration grid for one bucket.

    Returns (node_sel [G, ac], ghw_prod [G], val_idx [G, ad] int32) where the
    grid spans GH nodes for latent cont slots (a single dummy node for
    observed ones) × value indices for latent disc slots.
    """
    ghx, ghw = np.polynomial.hermite.hermgauss(n_quad)
    ghw = ghw / np.sqrt(np.pi)  # normalized: sum = 1

    axes = []
    kinds = []  # ('c', slot) or ('d', slot)
    for p, lat in enumerate(b.cont_lat):
        axes.append(np.arange(n_quad) if lat else np.array([0]))
        kinds.append(("c", p))
    for p, lat in enumerate(b.disc_lat):
        axes.append(np.arange(max_v) if lat else np.array([0]))
        kinds.append(("d", p))
    mesh = np.meshgrid(*axes, indexing="ij") if axes else []
    G = int(mesh[0].size) if mesh else 1

    node_sel = np.zeros((G, len(b.cont_lat)), np.float64)  # GH node value
    ghw_prod = np.ones(G, np.float64)
    val_idx = np.zeros((G, len(b.disc_lat)), np.int32)
    for (kind, p), m in zip(kinds, mesh):
        flat = m.reshape(-1)
        if kind == "c":
            if b.cont_lat[p]:
                node_sel[:, p] = ghx[flat]
                ghw_prod *= ghw[flat]
            # observed slot: node 0, weight 1 (value comes from cont_const)
        else:
            val_idx[:, p] = flat
    return (
        jnp.asarray(node_sel, jnp.float32),
        jnp.asarray(ghw_prod, jnp.float32),
        jnp.asarray(val_idx),
    )


def _bucket_expected_logpot(
    fg: CompiledFG, b: FactorBucket, params: VIParams, bd: Array, n_quad: int
) -> Array:
    """Σ_f scale_f Σ_k w_k E_{b_k}[log φ_f] for one bucket."""
    node_sel, ghw_prod, val_idx = _bucket_grid(b, n_quad, fg.max_v)
    G = ghw_prod.shape[0]
    n_f, ac, ad = b.n_factors, b.ac, b.ad

    # continuous evaluation points: [K, n_f, G, ac]
    K = params.mu.shape[0]
    if ac and params.mu.shape[1]:
        mu = params.mu[:, b.cont_idx]  # [K, n_f, ac]
        sig = jnp.exp(params.log_sigma)[:, b.cont_idx]
        lat = b.cont_mask[None, :, None, :]
        pts = (
            mu[:, :, None, :]
            + jnp.sqrt(2.0) * sig[:, :, None, :] * node_sel[None, None, :, :]
        )
        xs = jnp.where(lat > 0, pts, b.cont_const[None, :, None, :])
    elif ac:  # every cont slot observed (no latent cont vars to gather)
        xs = jnp.broadcast_to(
            b.cont_const[None, :, None, :], (K, n_f, G, ac)
        )
    else:
        xs = jnp.zeros((K, n_f, G, 0))

    # discrete grid indices: [n_f, G, ad] (+ observed slots from disc_const)
    if ad:
        xdi = jnp.where(
            b.disc_mask[:, None, :] > 0,
            jnp.broadcast_to(val_idx[None], (n_f, G, ad)),
            b.disc_const[:, None, :],
        )
        xdv = b.slot_values(xdi)
        # per-component weight of each grid point: Π over latent disc slots
        # of b_k(var)[val]; invalid values carry zero belief mass.
        if bd.shape[1]:
            bprob = bd[:, b.disc_idx]  # [K, n_f, ad, Vmax]
            sel = select_last(
                bprob[:, :, None, :, :], xdi[None]
            )  # [K, n_f, G, ad]
            w_disc = jnp.prod(
                jnp.where(b.disc_mask[None, :, None, :] > 0, sel, 1.0),
                axis=-1,
            )  # [K, n_f, G]
        else:  # every disc slot observed (no latent disc vars to gather)
            w_disc = jnp.ones((K, n_f, G))
    else:
        xdi = jnp.zeros((n_f, G, 0), jnp.int32)
        xdv = jnp.zeros((n_f, G, 0))
        w_disc = jnp.ones((1, n_f, G))

    pk = expand_params(b.params, 1)  # [n_f, 1, ...] vs grid axis
    log_phi = b.kernel(pk, xs, xdi[None], xdv[None])  # [K, n_f, G]
    log_phi = jnp.clip(jnp.nan_to_num(log_phi, neginf=_NEG_BIG), _NEG_BIG, None)
    e_kf = jnp.sum(ghw_prod[None, None, :] * w_disc * log_phi, axis=-1)  # [K, n_f]
    w = jax.nn.softmax(params.log_w)
    return jnp.sum(b.scale[None, :] * w[:, None] * e_kf)


def mixture_entropy_bound(fg: CompiledFG, params: VIParams, bd: Array) -> Array:
    """Lower bound on the mixture entropy: the max of two valid bounds.

    (a) Jensen pairwise-overlap bound (the reference OSI's H̃):
        H(q) ≥ −Σ_k w_k log Σ_l w_l z_kl,  z_kl = ∫ q_k q_l.
        Tight for well-separated components, but degrades to Rényi-2
        entropy when components coincide (noticeably loose for discrete
        marginals even at K=1).
    (b) Conditional-entropy bound: H(q) ≥ Σ_k w_k H(q_k) — exact at K=1
        and for identical components.

    Both hold for every parameter value, so their pointwise maximum is a
    valid (and tighter) bound. Per-variable terms are weighted by lifted
    orbit counts; everything stays f32 (SURVEY.md §9 hard part (b)).
    """
    w = jax.nn.softmax(params.log_w)
    log_w = jax.nn.log_softmax(params.log_w)

    # --- (a) pairwise-overlap Jensen bound ------------------------------
    log_z = jnp.zeros((params.mu.shape[0], params.mu.shape[0]))
    if fg.n_cont:
        mu_k = params.mu[:, None, :]  # [K, 1, n]
        mu_l = params.mu[None, :, :]
        v_k = jnp.exp(2.0 * params.log_sigma)[:, None, :]
        v_l = jnp.exp(2.0 * params.log_sigma)[None, :, :]
        var = v_k + v_l
        per_var = -0.5 * (
            jnp.log(2.0 * jnp.pi * var) + (mu_k - mu_l) ** 2 / var
        )  # [K, K, n]
        log_z = log_z + jnp.sum(fg.cont_counts[None, None, :] * per_var, axis=-1)
    if fg.n_disc:
        ov = jnp.sum(bd[:, None] * bd[None, :], axis=-1)  # [K, K, n_disc]
        log_ov = jnp.log(jnp.maximum(ov, 1e-30))
        log_z = log_z + jnp.sum(fg.disc_counts[None, None, :] * log_ov, axis=-1)
    inner = jax.scipy.special.logsumexp(log_w[None, :] + log_z, axis=1)  # [K]
    h_jensen = -jnp.sum(w * inner)

    # --- (b) conditional-entropy bound ----------------------------------
    h_comp = jnp.zeros(params.mu.shape[0])
    if fg.n_cont:
        h_gauss = params.log_sigma + 0.5 * jnp.log(2.0 * jnp.pi * jnp.e)
        h_comp = h_comp + jnp.sum(fg.cont_counts[None, :] * h_gauss, axis=-1)
    if fg.n_disc:
        h_cat = -jnp.sum(
            jnp.where(bd > 0, bd * jnp.log(jnp.maximum(bd, 1e-30)), 0.0),
            axis=-1,
        )  # [K, n_disc]
        h_comp = h_comp + jnp.sum(fg.disc_counts[None, :] * h_cat, axis=-1)
    h_cond = jnp.sum(w * h_comp)

    return jnp.maximum(h_jensen, h_cond)


def _quad_expected(fg: CompiledFG, params: VIParams) -> Array:
    """Closed-form Σ_k w_k E_{b_k}[−½xJx + hx + c] for the fused quadratic
    information form: E[xJx] = μᵀJμ + Σ_i J_ii σ_i² under mean-field."""
    w = jax.nn.softmax(params.log_w)
    mu = params.mu  # [K, n]
    s2 = jnp.exp(2.0 * params.log_sigma)
    # f32 products (not TF32): the ELBO and its gradient are the optimizer's
    # objective
    hi = jax.lax.Precision.HIGHEST
    if fg.quad_sparse:
        quad = jnp.sum(mu * fg.quad_matvec_batched(mu), axis=-1) + jnp.dot(
            s2, fg.quad_diag, precision=hi)
    else:
        quad = jnp.einsum("ki,ij,kj->k", mu, fg.quad_J, mu,
                          precision=hi) + jnp.dot(
            s2, jnp.diagonal(fg.quad_J), precision=hi)
    lin = jnp.dot(mu, fg.quad_h, precision=hi)
    return jnp.sum(w * (-0.5 * quad + lin + fg.quad_c))


def elbo(fg: CompiledFG, params: VIParams, n_quad: int) -> Array:
    bd = beliefs_disc(fg, params)
    total = mixture_entropy_bound(fg, params, bd)
    if fg.has_quad:
        total = total + _quad_expected(fg, params)
    for i in fg.lp_bucket_idx:
        total = total + _bucket_expected_logpot(
            fg, fg.buckets[i], params, bd, n_quad
        )
    return total


@partial(jax.jit, static_argnames=("cfg",))
def _fit_from(fg: CompiledFG, params: VIParams, cfg: VIConfig):
    """Optimize the ELBO from given initial params."""
    opt = optax.adam(cfg.lr)
    opt_state = opt.init(params)

    def step(carry, _):
        params, opt_state = carry
        loss, grads = jax.value_and_grad(
            lambda p: -elbo(fg, p, cfg.n_quad)
        )(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), -loss

    (params, _), trace = jax.lax.scan(
        step, (params, opt_state), None, length=cfg.n_iters
    )
    return params, trace


def fit(fg: CompiledFG, key: Array, cfg: VIConfig = VIConfig()):
    """Optimize the ELBO; returns (params, elbo_trace [n_iters])."""
    return _fit_from(fg, init_params(fg, key, cfg), cfg)


class VIResult:
    """Mixture-belief queries (reference ``belief``/``map`` parity)."""

    def __init__(self, fg: CompiledFG, params: VIParams, trace=None):
        self.fg = fg
        self.params = jax.device_get(params)
        self.trace = None if trace is None else np.asarray(trace)
        self.w = np.asarray(jax.nn.softmax(jnp.asarray(self.params.log_w)))
        self.bd = np.asarray(beliefs_disc(fg, params))

    def _loc(self, rv, want):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            raise ValueError(f"{rv} is observed (evidence); it has no posterior")
        if kind != want:
            raise ValueError(f"{rv} is {'continuous' if kind == 'c' else 'discrete'}")
        return i

    def mean(self, rv) -> float:
        i = self._loc(rv, "c")
        return float(np.sum(self.w * np.asarray(self.params.mu)[:, i]))

    def var(self, rv) -> float:
        i = self._loc(rv, "c")
        mu = np.asarray(self.params.mu)[:, i]
        s2 = np.exp(2.0 * np.asarray(self.params.log_sigma)[:, i])
        m = np.sum(self.w * mu)
        return float(np.sum(self.w * (s2 + mu**2)) - m**2)

    def disc_marginal(self, rv) -> np.ndarray:
        i = self._loc(rv, "d")
        size = self.fg.meta.disc_size(rv)
        return np.einsum("k,kv->v", self.w, self.bd[:, i, :size])

    def belief(self, x, rv) -> float:
        """Mixture marginal density/pmf of rv at x."""
        kind, i = self.fg.meta.loc(rv)
        if kind == "c":
            mu = np.asarray(self.params.mu)[:, i]
            s = np.exp(np.asarray(self.params.log_sigma)[:, i])
            dens = np.exp(-0.5 * ((x - mu) / s) ** 2) / (s * np.sqrt(2 * np.pi))
            return float(np.sum(self.w * dens))
        probs = self.disc_marginal(rv)
        return float(probs[self.fg.meta.value_index(rv, x)])

    def map(self, rv):
        kind, i = self.fg.meta.loc(rv)
        if kind == "d":
            probs = self.disc_marginal(rv)
            return self.fg.meta.disc_values(rv)[int(probs.argmax())]
        # mixture MODE: argmax of the actual mixture density (a w_k/σ_k
        # component heuristic is silently wrong for overlapping
        # components) — dense grid over the mixture support + parabolic
        # refinement of the winning cell
        mu = np.asarray(self.params.mu)[:, i]
        s = np.exp(np.asarray(self.params.log_sigma)[:, i])
        lo = float((mu - 4.0 * s).min())
        hi = float((mu + 4.0 * s).max())
        grid = np.linspace(lo, hi, 2049)
        dens = np.sum(
            self.w[:, None]
            * np.exp(-0.5 * ((grid[None, :] - mu[:, None]) / s[:, None]) ** 2)
            / (s[:, None] * np.sqrt(2 * np.pi)),
            axis=0,
        )
        j = int(np.argmax(dens))
        if 0 < j < len(grid) - 1:
            # parabola through the three points around the max
            y0, y1, y2 = dens[j - 1], dens[j], dens[j + 1]
            denom = y0 - 2.0 * y1 + y2
            if denom < 0:
                dx = 0.5 * (y0 - y2) / denom
                return float(grid[j] + dx * (grid[1] - grid[0]))
        return float(grid[j])


def infer(fg: CompiledFG, key, cfg: VIConfig = VIConfig()) -> VIResult:
    params, trace = fit(fg, key, cfg)
    return VIResult(fg, params, trace)


# ---------------------------------------------------------------------------
# Coarse-to-fine lifted VI (reference "OSI C2F variant" parity,
# SURVEY.md §3.1): optimize on a coarse orbit partition, then split
# clusters and warm-start the finer stage. The cluster hierarchy comes
# from truncated color refinement: ``max_rounds`` rounds of color passing
# give ever-finer valid partitions, ending at the fixpoint (exact lifted)
# or the fully grounded graph.
# ---------------------------------------------------------------------------


def _transfer_params(fg_a: CompiledFG, fg_b: CompiledFG,
                     params: VIParams) -> VIParams:
    """Warm-start stage-B params by copying each ground RV's stage-A orbit
    params into its (finer) stage-B slot."""
    import numpy as np

    g = fg_a.meta.graph
    K = params.mu.shape[0]
    c_src = np.zeros(max(fg_b.n_cont, 1), np.int64)
    d_src = np.zeros(max(fg_b.n_disc, 1), np.int64)
    for rv in g.rvs:
        if rv.observed:
            continue
        k_a, i_a = fg_a.meta.loc(rv)
        k_b, i_b = fg_b.meta.loc(rv)
        if k_b == "c":
            c_src[i_b] = i_a
        else:
            d_src[i_b] = i_a
    mu = params.mu[:, c_src[: fg_b.n_cont]] if fg_b.n_cont else jnp.zeros(
        (K, 0)
    )
    ls = params.log_sigma[:, c_src[: fg_b.n_cont]] if fg_b.n_cont else (
        jnp.zeros((K, 0))
    )
    lg = (
        params.logits[:, d_src[: fg_b.n_disc]]
        if fg_b.n_disc
        else jnp.zeros((K, 0, fg_b.max_v))
    )
    return VIParams(log_w=params.log_w, mu=mu, log_sigma=ls, logits=lg)


def infer_c2f(
    g,
    key,
    cfg: VIConfig = VIConfig(),
    schedule=(0, None, "ground"),
    pad_to: int = 8,
) -> VIResult:
    """Coarse-to-fine VI over a refinement schedule.

    ``schedule`` entries: int = that many color-refinement rounds
    (0 = coarsest: domain/evidence/potential-type classes), ``None`` =
    fixpoint (exact lifted partition), ``"ground"`` = fully grounded.
    ``cfg.n_iters`` is split evenly across stages; each stage warm-starts
    from the previous partition's parameters.
    """
    from lhvi_tpu.fg.compile import compile_graph
    from lhvi_tpu.lift import compile_lifted

    import numpy as np

    if not schedule:
        raise ValueError("infer_c2f: schedule must be non-empty")
    base = cfg.n_iters // len(schedule)
    iters = max(base, 1)
    # only add the remainder when the division wasn't clamped, so the
    # total equals cfg.n_iters whenever n_iters >= len(schedule) (below
    # that, every stage runs its 1-iteration minimum)
    rem = cfg.n_iters % len(schedule) if base >= 1 else 0
    params = None
    prev_fg = None
    traces = []
    for si, stage in enumerate(schedule):
        # the final stage absorbs the integer-division remainder so the
        # total step count equals cfg.n_iters
        stage_cfg = cfg.replace(
            n_iters=iters + (rem if si == len(schedule) - 1 else 0))
        if stage == "ground":
            fg = compile_graph(g, pad_to=pad_to)
        else:
            rounds = 10_000 if stage is None else int(stage)
            fg = compile_lifted(g, pad_to=pad_to, max_rounds=rounds)
        if params is None:
            params = init_params(fg, jax.random.fold_in(key, si), stage_cfg)
        else:
            params = _transfer_params(prev_fg, fg, params)
        params, trace = _fit_from(fg, params, stage_cfg)
        traces.append(np.asarray(trace))
        prev_fg = fg
    return VIResult(fg, params, np.concatenate(traces))


def infer_c2f_fast(
    fg: CompiledFG,
    key,
    cfg: VIConfig = VIConfig(),
    schedule=(1, None, "ground"),
) -> VIResult:
    """Coarse-to-fine VI on a grounded :class:`CompiledFG` — no object
    graph anywhere, so it composes with ``relational.fast.fast_compile``
    and runs at million-latent scale.

    ``schedule`` entries: int k ≥ 1 = k rounds of IR-level color
    refinement (``lift.fast.refine_ir``; round 1 is the coarsest useful
    partition: domain/evidence/row-param classes), ``None`` = fixpoint
    (exact lifted partition), ``"ground"`` = the input graph itself.
    Refinement is monotone in rounds, so each stage's orbits split the
    previous stage's and params warm-start by orbit inheritance — the
    same semantics as :func:`infer_c2f` on the object path.
    """
    from lhvi_tpu.lift.fast import fast_lift

    import numpy as np

    if not schedule:
        raise ValueError("infer_c2f_fast: schedule must be non-empty")
    base = cfg.n_iters // len(schedule)
    iters = max(base, 1)
    rem = cfg.n_iters % len(schedule) if base >= 1 else 0
    ident = (np.arange(fg.n_cont), np.arange(fg.n_disc))
    params = None
    prev_cols = None
    traces = []
    for si, stage in enumerate(schedule):
        stage_cfg = cfg.replace(
            n_iters=iters + (rem if si == len(schedule) - 1 else 0))
        if stage == "ground":
            fg_s, cols = fg, ident
        else:
            rounds = 10_000 if stage is None else max(int(stage), 1)
            fg_s = fast_lift(fg, max_rounds=rounds)
            cols = (fg_s.meta._c, fg_s.meta._d)
        if params is None:
            params = init_params(fg_s, jax.random.fold_in(key, si), stage_cfg)
        else:
            # ground→orbit maps give the transfer vectorized: stage-B slot
            # cols_b[g] inherits stage-A slot cols_a[g] (consistent because
            # refinement is monotone: every B orbit lies inside one A orbit)
            K = params.mu.shape[0]
            c_src = np.zeros(max(fg_s.n_cont, 1), np.int64)
            c_src[cols[0]] = prev_cols[0]
            d_src = np.zeros(max(fg_s.n_disc, 1), np.int64)
            d_src[cols[1]] = prev_cols[1]
            # the inheritance scatter is only well-defined when the
            # schedule is genuinely coarse-to-fine (every current orbit
            # lies inside exactly one previous-stage orbit); verify the
            # scatter round-trips instead of silently picking a writer
            if (np.any(c_src[cols[0]] != prev_cols[0])
                    or np.any(d_src[cols[1]] != prev_cols[1])):
                raise ValueError(
                    "infer_c2f_fast: schedule is not coarse-to-fine — "
                    f"stage {si} ({stage!r}) orbits do not refine stage "
                    f"{si - 1}'s; order schedule entries from fewer to "
                    "more refinement rounds")
            params = VIParams(
                log_w=params.log_w,
                mu=(params.mu[:, c_src[: fg_s.n_cont]]
                    if fg_s.n_cont else jnp.zeros((K, 0))),
                log_sigma=(params.log_sigma[:, c_src[: fg_s.n_cont]]
                           if fg_s.n_cont else jnp.zeros((K, 0))),
                logits=(params.logits[:, d_src[: fg_s.n_disc]]
                        if fg_s.n_disc else jnp.zeros((K, 0, fg_s.max_v))),
            )
        params, trace = _fit_from(fg_s, params, stage_cfg)
        traces.append(np.asarray(trace))
        prev_cols = cols
        last_fg = fg_s
    return VIResult(last_fg, params, np.concatenate(traces))
