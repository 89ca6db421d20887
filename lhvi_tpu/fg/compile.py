"""Graph-to-XLA factor compiler: the keystone of the batched design.

The reference walks Python object graphs inside every engine loop
(SURVEY.md §4). Here the graph is compiled ONCE (host side) into a
statically-shaped, bucketed array IR — ``CompiledFG`` — and every engine
consumes only that IR under ``jit``:

- factors are grouped into **buckets** by (potential bucket key, continuity
  pattern); one batched kernel evaluates a whole bucket;
- evidence is baked in as per-slot constants + masks (no shape change when
  evidence changes pattern within a bucket);
- bucket sizes are padded to a multiple of ``pad_to`` with zero-weight rows
  so shapes are stable across models of similar size;
- per-factor ``scale`` carries lifted orbit counts (1.0 when grounded,
  0.0 for padding);
- a chromatic schedule (greedy conflict coloring of discrete latents) is
  precomputed for parallel-Gibbs discrete updates.

This realizes the "graph-to-XLA factor compiler" subsystem of
BASELINE.json's north-star.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from lhvi_tpu.utils import struct

from lhvi_tpu.fg.graph import Domain, F, Graph, RV
from lhvi_tpu.ops.select import select_last

Array = jax.Array

_NEG_BIG = -1e30


class FGMeta:
    """Host-side metadata: RV ↔ flat-index maps (hash by identity so it can
    ride in a static pytree field).

    ``np_buckets``/``np_global`` mirror the compiled index arrays in host
    numpy. Engine SETUP code (LBP/EPBP table builders, Gibbs plan) must
    read these instead of ``np.asarray(bucket.xxx)``, so setup never
    waits on a device→host readback.
    """

    def __init__(self):
        self.cont_rvs: List[RV] = []
        self.disc_rvs: List[RV] = []
        self.index: Dict[int, Tuple[str, int]] = {}  # id(rv) -> (kind, idx)
        self.graph: Graph = None
        self.cont_counts: np.ndarray = None  # lifted orbit sizes (None=grounded)
        self.disc_counts: np.ndarray = None
        self.orbit_of: Dict[int, int] = None  # id(ground rv) -> orbit var idx
        self.np_buckets: List[Dict[str, np.ndarray]] = []
        self.np_global: Dict[str, np.ndarray] = {}

    def loc(self, rv: RV) -> Tuple[str, int]:
        """('c'|'d'|'obs', flat index) of an RV in the compiled state."""
        return self.index[id(rv)]

    # Engine result accessors resolve domain facts through these hooks
    # (instead of touching rv.domain directly) so metas that address
    # variables by KEY rather than by RV object — the direct relational
    # compiler's FastMeta — work with every engine unchanged.
    def disc_size(self, rv) -> int:
        return rv.domain.size

    def disc_values(self, rv):
        return rv.domain.values

    def value_index(self, rv, x) -> int:
        return rv.domain.value_index(x)

    def obs_value(self, rv):
        return rv.value

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@struct.dataclass
class FactorBucket:
    """One potential-type bucket: ``n_f`` same-kernel factors, batched."""

    kind: str = struct.field(pytree_node=False)
    pattern: Tuple[bool, ...] = struct.field(pytree_node=False)
    # uniform per-bucket latency flags (evidence pattern is part of the
    # bucket key, so every factor in a bucket shares them): one bool per
    # cont / disc slot, True = latent. Static → usable for grid construction.
    cont_lat: Tuple[bool, ...] = struct.field(pytree_node=False)
    disc_lat: Tuple[bool, ...] = struct.field(pytree_node=False)
    kernel: Callable = struct.field(pytree_node=False)
    params: Dict[str, Array]  # leaves [n_f, ...]
    cont_idx: Array  # i32 [n_f, ac] into x_c (0 where not latent)
    cont_mask: Array  # f32 [n_f, ac] 1=latent
    cont_const: Array  # f32 [n_f, ac] evidence values
    disc_idx: Array  # i32 [n_f, ad] into x_d
    disc_mask: Array  # f32 [n_f, ad]
    disc_first: Array  # f32 [n_f, ad] 1 = first latent occurrence of its var
    disc_const: Array  # i32 [n_f, ad] evidence value-indices
    disc_vals: Array  # f32 [n_f, ad, Vmax] slot index->value tables
    disc_size: Array  # i32 [n_f, ad] slot domain sizes
    scale: Array  # f32 [n_f] orbit count (0 = padding)
    # optional slot-major kernel (potentials.base.Potential.kernel_planar)
    # — the layout a fused non-quadratic leapfrog kernel would consume
    kernel_planar: Any = struct.field(pytree_node=False, default=None)

    @property
    def n_factors(self) -> int:
        return self.scale.shape[0]

    @property
    def ac(self) -> int:
        return self.cont_idx.shape[1]

    @property
    def ad(self) -> int:
        return self.disc_idx.shape[1]

    def gather_args(self, xc: Array, xd: Array, extra_batch: int = 0):
        """Assemble kernel args from flat state vectors.

        Returns (params, xcs [n_f, ac], xdi [n_f, ad], xdv [n_f, ad]) with
        ``extra_batch`` singleton axes inserted into params after axis 0 (for
        broadcasting against grid/candidate axes added by callers).
        """
        xcs = jnp.where(
            self.cont_mask > 0,
            xc[self.cont_idx] if xc.shape[0] else jnp.zeros_like(self.cont_const),
            self.cont_const,
        )
        xdi = jnp.where(
            self.disc_mask > 0,
            xd[self.disc_idx] if xd.shape[0] else jnp.zeros_like(self.disc_const),
            self.disc_const,
        )
        xdv = self.slot_values(xdi)
        params = self.params
        if extra_batch:
            params = expand_params(params, extra_batch)
        return params, xcs, xdi, xdv

    def slot_values(self, xdi: Array) -> Array:
        """Map slot value-indices ``[n_f, *extra, ad]`` → domain values."""
        if self.ad == 0:
            return xdi.astype(jnp.float32)
        n_extra = xdi.ndim - 2  # axes between the factor axis and the slot axis
        vals = self.disc_vals.reshape(
            (self.disc_vals.shape[0],) + (1,) * n_extra + self.disc_vals.shape[1:]
        )
        return select_last(vals, xdi)

    def gather_args_batched(self, xc: Array, xd: Array):
        """Batched ``gather_args``: state ``[C, n_cont]/[C, n_disc]`` →
        ``(params [1, n_f, …], xcs [C, n_f, ac], xdi, xdv [C, n_f, ad])``.

        One fused gather program for the whole batch — the chains/particles
        hot path; per-state ``vmap`` over :meth:`gather_args` produces the
        same values (identity-tested in ``tests/test_compile.py``).
        """
        C = xc.shape[0]
        xcs = jnp.where(
            self.cont_mask[None] > 0,
            xc[:, self.cont_idx]
            if xc.shape[1]
            else jnp.broadcast_to(self.cont_const, (C,) + self.cont_const.shape),
            self.cont_const[None],
        )
        xdi = jnp.where(
            self.disc_mask[None] > 0,
            xd[:, self.disc_idx]
            if xd.shape[1]
            else jnp.broadcast_to(self.disc_const, (C,) + self.disc_const.shape),
            self.disc_const[None],
        )
        if self.ad:
            xdv = select_last(self.disc_vals[None], xdi)
        else:
            xdv = xdi.astype(jnp.float32)
        params = jax.tree_util.tree_map(lambda a: a[None], self.params)
        return params, xcs, xdi, xdv


def expand_params(params: Dict[str, Array], n_axes: int) -> Dict[str, Array]:
    """Insert ``n_axes`` singleton axes after axis 0 of every leaf."""

    def ex(leaf):
        return leaf.reshape(leaf.shape[:1] + (1,) * n_axes + leaf.shape[1:])

    return jax.tree_util.tree_map(ex, params)


@struct.dataclass
class GibbsGather:
    """Compile-time gather plan for discrete full-conditional logits.

    Scatter-adds into ``[n_disc, V]`` serialize on colliding indices and
    batch badly across chains, so the Gibbs
    logits are assembled by GATHER instead: every (bucket, slot, factor)
    contribution gets a static flat row id; variables are grouped by
    incidence degree with per-group index tables into the flat
    contribution array (row F_tot = zero padding); a static permutation
    maps group-concatenated results back to variable order.
    """

    degrees: Tuple[int, ...] = struct.field(pytree_node=False)
    idx: Tuple[Array, ...]  # per group i32 [m_g, d_g] into flat rows
    pos_of_var: Array  # i32 [n_disc] var -> row in concat(group outputs)


@struct.dataclass
class GibbsColorGroup:
    """One scan-group of a ``GibbsColorPlan``: colors of similar cost,
    padded to uniform shapes so a single ``lax.scan`` sweeps them.

    Per color the tables hold EXACTLY the factor rows adjacent to that
    color's variables (pre-gathered at compile time), so a full exact
    chromatic sweep costs O(Σ_v deg(v)) kernel-row evaluations instead of
    the old O(n_colors · n_factors) all-rows-every-color pass — the
    pod-scale Gibbs hot-path fix (SURVEY.md §3.2 "chromatic Gibbs";
    BASELINE north-star log-potential kernel, mount empty).

    ``bucket_tabs[i]`` is ``None`` when bucket ``i`` has no rows in this
    group; otherwise a dict of arrays with leading dims ``[nc, R]``:
    pre-gathered bucket slot tables plus ``sub`` (slots referencing the
    target variable — substituted jointly by the candidate value),
    ``disc_cval`` (domain values of observed slots' baked indices),
    ``sub_vals`` ([nc, R, Vmax] candidate domain values of the target
    variable — value lookups stay in value space at runtime; see
    ``hmc._color_class_logits``), ``w`` (factor scale; 0 = padding),
    ``vidx`` ([nc, M, D] per-var gather into the color's row block;
    index R = zero row), and ``params`` (pre-gathered per-factor kernel
    params).
    """

    n_colors: int = struct.field(pytree_node=False)
    n_vars: int = struct.field(pytree_node=False)  # M = padded class size
    vars_: Array  # i32 [nc, M] global discrete var ids (pad = n_disc)
    sizes: Array  # i32 [nc, M] domain sizes (pad = 1)
    vals_: Array  # f32 [nc, M, Vmax] index->domain value per class var
    #               (None when the plan's values_are_indices flag is set —
    #                the sweep never reads it, so it is not built)
    bucket_tabs: Tuple  # per bucket: None | dict of [nc, R, …] arrays


@struct.dataclass
class GibbsColorPlan:
    groups: Tuple[GibbsColorGroup, ...]
    # True when every latent discrete domain's values are exactly 0..K-1:
    # the sweep then derives slot values from indices and carries NO
    # value state at all (no second scatter per color step)
    values_are_indices: bool = struct.field(pytree_node=False,
                                            default=False)


@struct.dataclass
class CompiledFG:
    """Compiled factor graph: the array IR all engines consume.

    Quadratic fusion (matmul fast path): buckets whose log-potentials are
    quadratic in all-continuous arguments are additionally folded into the
    information form ``(quad_J, quad_h, quad_c)``; ``log_prob`` evaluates
    them as one matmul and skips those buckets (``lp_bucket_idx`` lists the
    survivors). ``buckets`` always holds EVERY factor — message-passing
    engines (LBP/EPBP) need per-factor structure and ignore the fusion.
    """

    buckets: Tuple[FactorBucket, ...]
    n_cont: int = struct.field(pytree_node=False)
    n_disc: int = struct.field(pytree_node=False)
    max_v: int = struct.field(pytree_node=False)
    n_colors: int = struct.field(pytree_node=False)
    has_quad: bool = struct.field(pytree_node=False)
    lp_bucket_idx: Tuple[int, ...] = struct.field(pytree_node=False)
    meta: FGMeta = struct.field(pytree_node=False)
    disc_sizes: Array  # i32 [n_disc]
    disc_vals: Array  # f32 [n_disc, Vmax] per-var index->value
    color_of: Array  # i32 [n_disc] chromatic-Gibbs color id per latent
    cont_lo: Array  # f32 [n_cont] domain bounds
    cont_hi: Array  # f32 [n_cont]
    cont_ipoints: Array  # f32 [n_cont, P] integral/discretization sites
    cont_counts: Array  # f32 [n_cont] lifted orbit sizes (1 = grounded)
    disc_counts: Array  # f32 [n_disc]
    quad_J: Array  # f32 [n_cont, n_cont] fused information matrix (or [0,0])
    quad_h: Array  # f32 [n_cont]
    quad_c: Array  # f32 scalar
    gibbs: GibbsGather
    color_plan: Any = None  # GibbsColorPlan | None (per-color Gibbs tables)
    # --- sparse (ELL) information form: n_cont > quad_max_n -------------
    # J in padded-neighbor layout: J@x = diag·x + Σ_k w[:,k]·x[col[:,k]] —
    # one [n, D] gather·multiply·sum, no scatters, static shapes. Set when
    # quad_sparse; quad_J stays [0,0] (a dense J at 16k vars is 1 GB).
    quad_diag: Any = None  # f32 [n_cont]
    quad_ell_col: Any = None  # i32 [n_cont, D]
    quad_ell_w: Any = None  # f32 [n_cont, D]
    quad_sparse: bool = struct.field(pytree_node=False, default=False)
    # --- banded (DIA) refinement of the ELL form ------------------------
    # When the active ELL offsets col[i,d]−i form a small static set
    # (grids: {±1, ±W}; chains: {±1}), J is banded and the matvec is K
    # static shift-multiply-accumulates instead of gathers (ops/dia.py;
    # HMCConfig.dia_kernel switches between DIA and ELL). offsets is
    # static; quad_dia_w is f32 [K, n_emb] in declaration-order embedded
    # coordinates; quad_dia_pos (i32 [n_cont], or None for identity)
    # scatters the latent state into that space.
    quad_dia_offsets: Any = struct.field(pytree_node=False, default=None)
    quad_dia_w: Any = None
    quad_dia_pos: Any = None
    quad_dia_inv: Any = None  # i32 [n_emb] inverse map (gather-embeds)
    # --- mode-swap move plan (engines/modeswap.py) ----------------------
    # orbit-grouped discrete latents for the block value-permutation MH
    # move that unlocks symmetric modes single-site chromatic Gibbs
    # cannot cross (ModeSwapPlan | None; built on demand by
    # ``modeswap.build_mode_swap_plan`` and attached via ``.replace``)
    mode_swap_plan: Any = None

    # ------------------------------------------------------------------
    @property
    def cont_pure_quad(self) -> bool:
        """True if the continuous energy is ENTIRELY the fused quadratic
        form (every surviving bucket ignores xc) — enables the fused
        quad-leapfrog fast path (ops.leapfrog / ops.dia)."""
        return self.has_quad and all(
            self.buckets[i].ac == 0 for i in self.lp_bucket_idx
        )

    def quad_matvec_batched(self, xc: Array) -> Array:
        """``J @ x`` rows for a batch: [C, n] → [C, n] (ELL form).

        Delegates to ``ops.leapfrog.ell_matvec`` — the single codegen
        point for the sparse matvec (unrolled gather·FMA; see its
        docstring)."""
        from lhvi_tpu.ops.leapfrog import ell_matvec

        return ell_matvec(xc, self.quad_diag, self.quad_ell_col,
                          self.quad_ell_w)

    def quad_log_prob_batched(self, xc: Array) -> Array:
        """Batched continuous energy of the fused form: [C, n] → [C].

        Products run at ``Precision.HIGHEST``: these energies feed MH
        ratios, which must stay f32 (not TF32) on GPUs."""
        hi = jax.lax.Precision.HIGHEST
        lin = jnp.dot(xc, self.quad_h, precision=hi)
        if self.quad_sparse:
            Jx = self.quad_matvec_batched(xc)
            return self.quad_c + lin - 0.5 * jnp.sum(xc * Jx, axis=-1)
        return self.quad_c + lin - 0.5 * jnp.einsum(
            "ci,ij,cj->c", xc, self.quad_J, xc, precision=hi)

    def log_prob(self, xc: Array, xd: Array) -> Array:
        """Unnormalized log p(x) = Σ_f scale_f · log φ_f. Jit/vmap friendly."""
        total = jnp.zeros((), jnp.float32)
        hi = jax.lax.Precision.HIGHEST
        if self.has_quad and self.quad_sparse:
            Jx = self.quad_matvec_batched(xc[None])[0]
            total = total + self.quad_c + jnp.dot(
                xc, self.quad_h - 0.5 * Jx, precision=hi)
        elif self.has_quad:
            Jx = jnp.dot(self.quad_J, xc, precision=hi)
            total = total + self.quad_c + jnp.dot(
                xc, self.quad_h - 0.5 * Jx, precision=hi)
        for i in self.lp_bucket_idx:
            b = self.buckets[i]
            params, xcs, xdi, xdv = b.gather_args(xc, xd)
            lp = b.kernel(params, xcs, xdi, xdv)
            total = total + jnp.sum(b.scale * lp)
        return total

    # ---- batched (chains/particles leading axis) log-prob family -----
    @property
    def cont_bucket_idx(self) -> Tuple[int, ...]:
        """Surviving buckets whose kernels actually read ``xc``."""
        return tuple(i for i in self.lp_bucket_idx if self.buckets[i].ac > 0)

    def _bucket_logp_batched(self, i: int, xc: Array, xd: Array) -> Array:
        b = self.buckets[i]
        params, xcs, xdi, xdv = b.gather_args_batched(xc, xd)
        lp = b.kernel(params, xcs, xdi, xdv)  # [C, n_f]
        return jnp.sum(b.scale[None] * lp, axis=-1)

    def log_prob_batched(self, xc: Array, xd: Array) -> Array:
        """``[C]`` log p for a batch of states.

        Equal to ``vmap(self.log_prob)`` but a single fused gather/kernel
        program per bucket — the engines' chains/particles hot path (no
        per-state program replication for XLA to re-fuse).
        """
        total = jnp.zeros((xc.shape[0],), jnp.float32)
        if self.has_quad:
            total = total + self.quad_log_prob_batched(xc)
        for i in self.lp_bucket_idx:
            total = total + self._bucket_logp_batched(i, xc, xd)
        return total

    def log_prob_cont_batched(self, xc: Array, xd: Array) -> Array:
        """``[C]`` continuous-state-dependent part of ``log_prob``.

        Sums the fused quadratic form plus only the buckets that reference
        ``xc`` — it differs from :meth:`log_prob_batched` by a term
        CONSTANT in ``xc`` (the purely-discrete buckets). Exact for
        continuous-update MH ratios at fixed ``xd`` and for ``∇_xc``,
        while skipping the (often dominant — e.g. pod-scale MLN cliques)
        discrete-only factor load entirely.
        """
        total = jnp.zeros((xc.shape[0],), jnp.float32)
        if self.has_quad:
            total = total + self.quad_log_prob_batched(xc)
        for i in self.cont_bucket_idx:
            total = total + self._bucket_logp_batched(i, xc, xd)
        return total

    @property
    def disc_bucket_idx(self) -> Tuple[int, ...]:
        """Surviving buckets whose kernels actually read ``xd`` — the
        candidate set the mode-swap plan's direct term is built from
        (``engines/modeswap.py``; quadratic-fused and continuous-only
        buckets are constant in ``xd`` and cancel in its MH ratios)."""
        return tuple(i for i in self.lp_bucket_idx if self.buckets[i].ad > 0)

    def disc_logits(self, xc: Array, xd: Array) -> Array:
        """Per-variable full-conditional logits for discrete latents.

        Returns f32 ``[n_disc, max_v]``: for each discrete latent d and each
        candidate value v, Σ over factors adjacent to d of
        ``scale · log φ`` with slot d forced to v (other slots at current
        state). Invalid candidate slots carry ``-1e30``. One fused pass per
        bucket×slot, assembled scatter-free via the precomputed
        ``GibbsGather`` plan — the chromatic-Gibbs inner kernel.

        Factors referencing the same discrete variable in multiple slots
        (grounded repeated args, or lifted same-orbit slots) are handled
        jointly: ALL slots sharing slot p's variable are set to the
        candidate value, and only the first occurrence contributes
        (``disc_first``), so such a factor yields ``log φ(v, …, v)`` once
        rather than a sum of single-slot substitutions.
        """
        V = self.max_v
        if self.n_disc == 0:
            return jnp.zeros((0, V))
        cand = jnp.arange(V, dtype=jnp.int32)
        rows = []
        for b in self.buckets:
            if b.ad == 0:
                continue
            params, xcs, xdi, xdv = b.gather_args(xc, xd, extra_batch=1)
            # broadcast current slots over the candidate axis: [n_f, V, a*]
            xcs_b = xcs[:, None, :]
            xdi_b = jnp.broadcast_to(xdi[:, None, :], (b.n_factors, V, b.ad))
            lat = b.disc_mask > 0
            for p in range(b.ad):
                # latent slots sharing slot p's variable (one-hot at p when
                # no repeats) — set jointly to the candidate value
                same = (
                    (b.disc_idx == b.disc_idx[:, p : p + 1])
                    & lat
                    & lat[:, p : p + 1]
                )
                xdi_p = jnp.where(same[:, None, :], cand[None, :, None], xdi_b)
                xdv_p = b.slot_values(xdi_p)
                lp = b.kernel(params, xcs_b, xdi_p, xdv_p)  # [n_f, V]
                w = b.scale * b.disc_mask[:, p] * b.disc_first[:, p]
                rows.append(jnp.nan_to_num(lp, neginf=_NEG_BIG) * w[:, None])
        if not rows:
            return jnp.full((self.n_disc, V), _NEG_BIG)
        flat = jnp.concatenate(rows + [jnp.zeros((1, V))], axis=0)
        parts = [
            jnp.sum(flat[idx_g], axis=1)  # [m_g, d_g, V] -> [m_g, V]
            for idx_g in self.gibbs.idx
        ]
        logits = jnp.concatenate(parts, axis=0)[self.gibbs.pos_of_var]
        valid = cand[None, :] < self.disc_sizes[:, None]
        return jnp.where(valid, logits, _NEG_BIG)

    def init_state(self, key: Array, jitter: float = 0.1):
        """A (xc, xd) state: continuous at domain midpoint + jitter,
        discrete uniform-random valid indices."""
        kc, kd = jax.random.split(key)
        mid = 0.5 * (self.cont_lo + self.cont_hi)
        span = jnp.minimum(self.cont_hi - self.cont_lo, 4.0)
        xc = mid + jitter * span * jax.random.normal(kc, (self.n_cont,))
        u = jax.random.uniform(kd, (self.n_disc,))
        xd = jnp.floor(u * self.disc_sizes).astype(jnp.int32)
        return xc, xd

    def init_state_batched(self, key: Array, n: int, jitter: float = 0.1):
        """[n, …] initial states drawn with two bulk PRNG calls — per-chain
        key splitting costs seconds at ≥64k chains."""
        kc, kd = jax.random.split(key)
        mid = 0.5 * (self.cont_lo + self.cont_hi)
        span = jnp.minimum(self.cont_hi - self.cont_lo, 4.0)
        xc = mid[None] + jitter * span[None] * jax.random.normal(
            kc, (n, self.n_cont)
        )
        u = jax.random.uniform(kd, (n, self.n_disc))
        xd = jnp.floor(u * self.disc_sizes[None]).astype(jnp.int32)
        return xc, xd


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to n rows by repeating row 0 (keeps kernels finite)."""
    if a.shape[0] == n:
        return a
    reps = np.repeat(a[:1], n - a.shape[0], axis=0)
    return np.concatenate([a, reps], axis=0)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def compile_graph(
    g: Graph,
    pad_to: int = 8,
    scales: Dict[int, float] = None,
    var_overrides: Dict[int, Tuple[str, int]] = None,
    n_cont_override: int = None,
    n_disc_override: int = None,
    cont_counts: np.ndarray = None,
    disc_counts: np.ndarray = None,
    fuse_quadratic: bool = True,
    quad_max_n: int = 4096,
    ell_max_deg: int = 128,
    gibbs_plan: bool = True,
) -> CompiledFG:
    """Compile a host ``Graph`` into the array IR.

    ``scales``/``var_overrides``/``n_*_override`` are the hooks the lifted
    compiler (``lhvi_tpu.lift``) uses to emit one representative factor per
    orbit with ``scale = |orbit|`` and orbit-tied variable slots.
    """
    g.init_nb()
    meta = FGMeta()
    meta.graph = g

    # --- assign state indices -------------------------------------------
    for rv in g.rvs:
        if var_overrides is not None and id(rv) in var_overrides:
            meta.index[id(rv)] = var_overrides[id(rv)]
            continue
        if rv.observed:
            meta.index[id(rv)] = ("obs", -1)
        elif rv.domain.continuous:
            meta.index[id(rv)] = ("c", len(meta.cont_rvs))
            meta.cont_rvs.append(rv)
        else:
            meta.index[id(rv)] = ("d", len(meta.disc_rvs))
            meta.disc_rvs.append(rv)

    n_cont = n_cont_override if n_cont_override is not None else len(meta.cont_rvs)
    n_disc = n_disc_override if n_disc_override is not None else len(meta.disc_rvs)

    # --- per-variable tables --------------------------------------------
    # (when the lifting pass overrides variable slots, it provides the
    #  per-slot domain via representative RVs; build tables from first
    #  writer of each slot)
    disc_dom: List[Domain] = [None] * n_disc
    cont_dom: List[Domain] = [None] * n_cont
    for rv in g.rvs:
        kind, i = meta.index[id(rv)]
        if kind == "d" and disc_dom[i] is None:
            disc_dom[i] = rv.domain
        elif kind == "c" and cont_dom[i] is None:
            cont_dom[i] = rv.domain

    max_v = max([d.size for d in disc_dom if d is not None] + [1])
    disc_sizes = np.array(
        [d.size if d is not None else 1 for d in disc_dom], np.int32
    ).reshape(n_disc)
    disc_vals = np.zeros((n_disc, max_v), np.float32)
    for i, d in enumerate(disc_dom):
        if d is not None:
            disc_vals[i, : d.size] = d.values

    n_ip = max([len(d.integral_points) for d in cont_dom if d is not None] + [1])
    cont_lo = np.zeros(n_cont, np.float32)
    cont_hi = np.zeros(n_cont, np.float32)
    cont_ip = np.zeros((n_cont, n_ip), np.float32)
    for i, d in enumerate(cont_dom):
        if d is None:
            continue
        cont_lo[i], cont_hi[i] = d.low, d.high
        ip = np.asarray(d.integral_points, np.float32)
        cont_ip[i, : len(ip)] = ip
        if len(ip) < n_ip:  # pad with last site (harmless duplicates)
            cont_ip[i, len(ip):] = ip[-1] if len(ip) else 0.0

    # --- bucket the factors ---------------------------------------------
    buckets_raw: Dict[Any, List[F]] = {}
    for f in g.factors:
        for rv in f.nb:
            if id(rv) not in meta.index:
                raise ValueError(
                    f"factor {f} references {rv} which is not in Graph.rvs"
                )
        pattern = tuple(rv.domain.continuous for rv in f.nb)
        latency = tuple(meta.index[id(rv)][0] != "obs" for rv in f.nb)
        # tied = some latent continuous state index appears in >1 slot
        # (grounded repeated args or lifted same-orbit slots). Quadratic
        # fusion is WRONG for tied factors: accumulate_information_form
        # would fold the cross coupling J_xy onto the diagonal, so a
        # mean-field expectation reads E[x²]=μ²+σ² where the tied-parameter
        # ground ELBO needs E[x_X]E[x_Y]=μ². Tied factors get their own
        # bucket and stay on the unfused path (independent quadrature axes).
        c_slots = [
            meta.index[id(rv)][1]
            for rv in f.nb
            if rv.domain.continuous and meta.index[id(rv)][0] == "c"
        ]
        cont_tied = len(c_slots) != len(set(c_slots))
        key = (f.potential.bucket_key(), pattern, latency, cont_tied)
        buckets_raw.setdefault(key, []).append(f)

    # --- quadratic fusion decision per bucket ---------------------------
    # n_cont ≤ quad_max_n fuses into a dense information form (one
    # matmul per log-prob/grad); beyond it the ELL sparse form keeps the
    # fused fast path alive
    from lhvi_tpu.fg.quad import (
        QUADRATIC_TYPES,
        accumulate_information_ell,
        accumulate_information_form,
    )

    do_fuse = fuse_quadratic and n_cont > 0
    fused_flags: List[bool] = []
    fused_factors: List[F] = []

    buckets: List[FactorBucket] = []
    for (bkey, pattern, latency, cont_tied), fs in buckets_raw.items():
        fusible = (
            do_fuse
            and isinstance(fs[0].potential, QUADRATIC_TYPES)
            and all(pattern)
            and not cont_tied
        )
        fused_flags.append(fusible)
        if fusible:
            fused_factors.extend(fs)
        ac = sum(pattern)
        ad = len(pattern) - ac
        n_raw = len(fs)
        n = _round_up(max(n_raw, 1), pad_to)

        p_stack: Dict[str, List[np.ndarray]] = {}
        c_idx = np.zeros((n_raw, ac), np.int32)
        c_mask = np.zeros((n_raw, ac), np.float32)
        c_const = np.zeros((n_raw, ac), np.float32)
        d_idx = np.zeros((n_raw, ad), np.int32)
        d_mask = np.zeros((n_raw, ad), np.float32)
        d_first = np.zeros((n_raw, ad), np.float32)
        d_const = np.zeros((n_raw, ad), np.int32)
        # value tables sized to THIS bucket's slot domains: the global
        # max_v covers latent domains only, and an OBSERVED discrete slot
        # may have a larger domain (every consumer reads the axis length
        # from the array shape, so per-bucket widths are safe)
        b_vmax = max(
            [rv.domain.size for f in fs for rv in f.nb
             if not rv.domain.continuous] + [1]
        )
        d_vals = np.zeros((n_raw, ad, b_vmax), np.float32)
        d_size = np.ones((n_raw, ad), np.int32)
        scale = np.ones(n_raw, np.float32)

        for r, f in enumerate(fs):
            if scales is not None:
                scale[r] = scales.get(id(f), 1.0)
            for k, v in f.potential.param_arrays().items():
                p_stack.setdefault(k, []).append(np.asarray(v, dtype=None))
            ci = di = 0
            seen_d: set = set()
            for rv, is_cont in zip(f.nb, pattern):
                kind, idx = meta.index[id(rv)]
                if is_cont:
                    if kind == "c":
                        c_idx[r, ci], c_mask[r, ci] = idx, 1.0
                    else:  # observed
                        c_const[r, ci] = float(rv.value)
                    ci += 1
                else:
                    dom = rv.domain
                    d_vals[r, di, : dom.size] = dom.values
                    if dom.size < b_vmax:
                        d_vals[r, di, dom.size:] = dom.values[-1]
                    d_size[r, di] = dom.size
                    if kind == "d":
                        d_idx[r, di], d_mask[r, di] = idx, 1.0
                        if idx not in seen_d:
                            d_first[r, di] = 1.0
                            seen_d.add(idx)
                    else:
                        d_const[r, di] = dom.value_index(rv.value)
                    di += 1

        params = {}
        for k, v in p_stack.items():
            stacked = np.stack(v)
            if np.issubdtype(stacked.dtype, np.floating):
                stacked = stacked.astype(np.float32)
            params[k] = _pad_rows(stacked, n)
        pad = lambda a: _pad_rows(a, n)  # noqa: E731
        scale_p = np.concatenate([scale, np.zeros(n - n_raw, np.float32)])
        kernel = fs[0].potential.kernel(pattern)
        kernel_planar = fs[0].potential.kernel_planar(pattern)
        cont_lat = tuple(l for l, c in zip(latency, pattern) if c)
        disc_lat = tuple(l for l, c in zip(latency, pattern) if not c)
        np_b = {
            "cont_idx": pad(c_idx),
            "cont_mask": (pad(c_mask) * (scale_p > 0)[:, None]
                          if ac else pad(c_mask)),
            "cont_const": pad(c_const),
            "disc_idx": pad(d_idx),
            "disc_mask": (pad(d_mask) * (scale_p > 0)[:, None]
                          if ad else pad(d_mask)),
            "disc_first": (pad(d_first) * (scale_p > 0)[:, None]
                           if ad else pad(d_first)),
            "disc_const": pad(d_const),
            "disc_vals": pad(d_vals),
            "disc_size": pad(d_size),
            "scale": scale_p,
            "params": params,  # numpy mirrors (color-plan pre-gather)
        }
        meta.np_buckets.append(np_b)
        buckets.append(
            FactorBucket(
                kind=str(bkey),
                pattern=pattern,
                cont_lat=cont_lat,
                disc_lat=disc_lat,
                kernel=kernel,
                kernel_planar=kernel_planar,
                params={k: jnp.asarray(v) for k, v in params.items()},
                cont_idx=jnp.asarray(np_b["cont_idx"]),
                cont_mask=jnp.asarray(np_b["cont_mask"]),
                cont_const=jnp.asarray(np_b["cont_const"]),
                disc_idx=jnp.asarray(np_b["disc_idx"]),
                disc_mask=jnp.asarray(np_b["disc_mask"]),
                disc_first=jnp.asarray(np_b["disc_first"]),
                disc_const=jnp.asarray(np_b["disc_const"]),
                disc_vals=jnp.asarray(np_b["disc_vals"]),
                disc_size=jnp.asarray(np_b["disc_size"]),
                scale=jnp.asarray(np_b["scale"]),
            )
        )

    # --- chromatic Gibbs schedule ---------------------------------------
    color_of = _greedy_color(g, meta, n_disc).astype(np.int32)
    n_colors = int(color_of.max() + 1) if n_disc else 1

    if cont_counts is None:
        cont_counts = np.ones(n_cont, np.float32)
    if disc_counts is None:
        disc_counts = np.ones(n_disc, np.float32)
    meta.cont_counts, meta.disc_counts = cont_counts, disc_counts

    # --- fold fused buckets into the information form -------------------
    has_quad = bool(fused_factors)
    quad_sparse = False
    quad_diag = quad_ell_col = quad_ell_w = None
    quad_dia_offsets = quad_dia_w = quad_dia_pos = quad_dia_inv = None
    J = None
    if has_quad and n_cont > quad_max_n:
        ell = accumulate_information_ell(
            fused_factors, meta, n_cont, scales=scales, max_deg=ell_max_deg
        )
        if ell is None:
            # densely coupled rows: ELL would be O(n²) — un-fuse and let
            # the bucket path evaluate these factors
            has_quad = False
            fused_flags = [False] * len(fused_flags)
            fused_factors = []
        else:
            diag_np, col_np, w_np, h, c = ell
            quad_sparse = True
            quad_diag = jnp.asarray(diag_np)
            quad_ell_col = jnp.asarray(col_np)
            quad_ell_w = jnp.asarray(w_np)
            quad_J = jnp.zeros((0, 0))
            quad_h = jnp.asarray(h, jnp.float32)
            quad_c = jnp.asarray(c, jnp.float32)
            # banded refinement: grids/chains compile to a static
            # diagonal-offset set → the DIA leapfrog (ops/dia.py).
            # Latent indices are evidence-compacted (irregular offsets on
            # any observed grid), so detection runs in DECLARATION-ORDER
            # coordinates: each latent's position among ALL continuous
            # RVs as declared — a row-major grid keeps its {±1, ±W}
            # template there, and the embedded state just carries inert
            # zero lanes at evidence positions (ops/dia.py).
            if var_overrides is None:
                from lhvi_tpu.ops.dia import ell_to_dia

                full_pos = np.empty(n_cont, np.int64)
                kfull = 0
                for rv in g.rvs:
                    if rv.domain.continuous:
                        kind, ii = meta.index[id(rv)]
                        if kind == "c":
                            full_pos[ii] = kfull
                        kfull += 1
                dia = ell_to_dia(col_np, w_np, pos=full_pos)
                if dia is not None:
                    from lhvi_tpu.ops.dia import pos_to_inv

                    quad_dia_offsets = dia[0]
                    quad_dia_w = jnp.asarray(dia[1])
                    if dia[2] is not None:
                        quad_dia_pos = jnp.asarray(dia[2], jnp.int32)
                        quad_dia_inv = jnp.asarray(
                            pos_to_inv(dia[2], n_cont))
    if has_quad and not quad_sparse:
        J, h, c = accumulate_information_form(
            fused_factors, meta, n_cont, scales=scales
        )
        quad_J = jnp.asarray(J, jnp.float32)
        quad_h = jnp.asarray(h, jnp.float32)
        quad_c = jnp.asarray(c, jnp.float32)
    if not has_quad:
        quad_J = jnp.zeros((0, 0))
        quad_h = jnp.zeros((0,))
        quad_c = jnp.zeros(())
    lp_bucket_idx = tuple(
        i for i, fused in enumerate(fused_flags) if not fused
    )

    gibbs = _build_gibbs_gather(meta.np_buckets, n_disc)
    color_plan = (
        _build_color_plan(meta.np_buckets, n_disc, color_of, disc_sizes,
                          disc_vals)
        if gibbs_plan
        else None
    )
    meta.np_global = {
        "disc_sizes": disc_sizes,
        "disc_vals": disc_vals,
        "color_of": color_of,
        "cont_lo": cont_lo,
        "cont_hi": cont_hi,
        "cont_ipoints": cont_ip,
        "cont_counts": np.asarray(cont_counts, np.float32),
        "disc_counts": np.asarray(disc_counts, np.float32),
    }

    return CompiledFG(
        buckets=tuple(buckets),
        n_cont=n_cont,
        n_disc=n_disc,
        max_v=max_v,
        n_colors=n_colors,
        has_quad=has_quad,
        lp_bucket_idx=lp_bucket_idx,
        meta=meta,
        disc_sizes=jnp.asarray(disc_sizes),
        disc_vals=jnp.asarray(disc_vals),
        color_of=jnp.asarray(color_of),
        cont_lo=jnp.asarray(cont_lo),
        cont_hi=jnp.asarray(cont_hi),
        cont_ipoints=jnp.asarray(cont_ip),
        cont_counts=jnp.asarray(cont_counts),
        disc_counts=jnp.asarray(disc_counts),
        quad_J=quad_J,
        quad_h=quad_h,
        quad_c=quad_c,
        gibbs=gibbs,
        color_plan=color_plan,
        quad_diag=quad_diag,
        quad_ell_col=quad_ell_col,
        quad_ell_w=quad_ell_w,
        quad_sparse=quad_sparse,
        quad_dia_offsets=quad_dia_offsets,
        quad_dia_w=quad_dia_w,
        quad_dia_pos=quad_dia_pos,
        quad_dia_inv=quad_dia_inv,
    )


def _build_gibbs_gather(np_buckets: List[Dict[str, np.ndarray]],
                        n_disc: int) -> GibbsGather:
    """Build the scatter-free Gibbs plan (see ``GibbsGather``) from the
    host-side numpy mirrors (never from device arrays — see ``FGMeta``).

    Flat row order must match ``disc_logits``'s emission order: buckets in
    order (skipping ad==0), slot-major, factor-minor.
    """
    all_vars: List[np.ndarray] = []
    all_rows: List[np.ndarray] = []
    off = 0
    for b in np_buckets:
        ad = b["disc_idx"].shape[1]
        if ad == 0:
            continue
        disc_idx = b["disc_idx"]
        disc_mask = b["disc_mask"] * b["disc_first"]
        n_f = disc_idx.shape[0]
        for p in range(ad):
            valid = disc_mask[:, p] > 0
            all_rows.append(off + np.nonzero(valid)[0].astype(np.int64))
            all_vars.append(disc_idx[valid, p].astype(np.int64))
            off += n_f
    return _group_gather(all_vars, all_rows, off, n_disc)


def _group_gather(all_vars: List[np.ndarray], all_rows: List[np.ndarray],
                  f_tot: int, n_var: int) -> GibbsGather:
    """Group (var, flat-row) incidences into degree-bucketed gather tables
    (row ``f_tot`` is the zero-padding row)."""
    if n_var == 0 or not all_vars:
        return GibbsGather(
            degrees=(),
            idx=(),
            pos_of_var=jnp.zeros(max(n_var, 0), jnp.int32),
        )

    vars_cat = np.concatenate(all_vars)
    rows_cat = np.concatenate(all_rows)
    order = np.argsort(vars_cat, kind="stable")
    rows_sorted = rows_cat[order]
    deg = np.bincount(vars_cat, minlength=n_var)
    starts = np.concatenate([[0], np.cumsum(deg)])

    def pad_deg(d: int) -> int:  # limit distinct group shapes
        if d <= 1:
            return 1
        p = 1
        while p < d:
            p *= 2
        return p

    group_vars: Dict[int, List[int]] = {}
    for v in range(n_var):
        group_vars.setdefault(pad_deg(int(deg[v])), []).append(v)

    degrees, idx_arrays = [], []
    pos_of_var = np.zeros(n_var, np.int64)
    pos = 0
    for d in sorted(group_vars):
        vs = group_vars[d]
        idx = np.full((len(vs), d), f_tot, np.int64)
        for r, v in enumerate(vs):
            k = int(deg[v])
            idx[r, :k] = rows_sorted[starts[v] : starts[v] + k]
            pos_of_var[v] = pos
            pos += 1
        degrees.append(d)
        idx_arrays.append(jnp.asarray(idx.astype(np.int32)))
    return GibbsGather(
        degrees=tuple(degrees),
        idx=tuple(idx_arrays),
        pos_of_var=jnp.asarray(pos_of_var.astype(np.int32)),
    )


def build_edge_gather(np_buckets: List[Dict[str, np.ndarray]],
                      patterns: List[Tuple[bool, ...]],
                      n_cont: int, n_disc: int) -> GibbsGather:
    """Gather plan over ALL latent (bucket, slot, factor) incidences with
    unified var ids (continuous first, then discrete). Flat row order:
    bucket-major, slot-major (full pattern order), factor-minor — matching
    ``[n_f, a, S].transpose(1,0,2).reshape(a·n_f, S)`` per bucket. Used by
    the message-passing engines to assemble beliefs scatter-free.
    """
    all_vars: List[np.ndarray] = []
    all_rows: List[np.ndarray] = []
    off = 0
    for np_b, pattern in zip(np_buckets, patterns):
        n_f = np_b["scale"].shape[0]
        ci = di = 0
        for p, is_cont in enumerate(pattern):
            if is_cont:
                mask = np_b["cont_mask"][:, ci] > 0
                gv = np_b["cont_idx"][:, ci]
                ci += 1
            else:
                mask = np_b["disc_mask"][:, di] > 0
                gv = n_cont + np_b["disc_idx"][:, di]
                di += 1
            all_rows.append((off + np.nonzero(mask)[0]).astype(np.int64))
            all_vars.append(gv[mask].astype(np.int64))
            off += n_f
    return _group_gather(all_vars, all_rows, off, n_cont + n_disc)


def _build_color_plan(np_buckets: List[Dict[str, np.ndarray]], n_disc: int,
                      color_of: np.ndarray, disc_sizes: np.ndarray,
                      disc_vals: np.ndarray = None,
                      row_cap: int = 50_000_000):
    """Compile the per-color Gibbs tables (see ``GibbsColorGroup``).

    For every (factor, discrete-var) adjacency edge, records the factor row,
    the slot-substitution mask (all slots referencing that var — matching
    ``disc_logits``'s joint-substitution semantics), the factor scale, and
    the target's position inside its color class. Edges are grouped by
    color, colors are grouped into power-of-two cost buckets (bounded
    padding), and every bucket's slot tables/params are pre-gathered per
    color so the runtime sweep only gathers *state* values.

    Returns ``None`` (fallback to the all-rows path) when there are no
    discrete latents, no edges, or the padded tables would exceed
    ``row_cap`` rows.
    """
    if n_disc == 0:
        return None
    n_colors = int(color_of.max() + 1)

    # --- per-bucket (factor, var) edges with joint substitution masks ----
    bucket_edges = []
    for np_b in np_buckets:
        ad = np_b["disc_idx"].shape[1]
        if ad == 0:
            bucket_edges.append(None)
            continue
        d_idx, d_mask, scale = (
            np_b["disc_idx"], np_b["disc_mask"], np_b["scale"]
        )
        keys, slots = [], []
        for p in range(ad):
            r = np.nonzero((d_mask[:, p] > 0) & (scale > 0))[0]
            keys.append(r.astype(np.int64) * n_disc + d_idx[r, p])
            slots.append(np.full(len(r), p, np.int64))
        keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
        if len(keys) == 0:
            bucket_edges.append(None)
            continue
        slots = np.concatenate(slots)
        uniq, inv = np.unique(keys, return_inverse=True)
        sub = np.zeros((len(uniq), ad), bool)
        sub[inv, slots] = True
        edge_r = (uniq // n_disc).astype(np.int64)
        edge_v = (uniq % n_disc).astype(np.int64)
        bucket_edges.append(
            (edge_r, edge_v, sub, np_b["scale"][edge_r].astype(np.float32))
        )
    if all(e is None for e in bucket_edges):
        return None

    def _bits(x: np.ndarray) -> np.ndarray:
        return np.ceil(np.log2(np.maximum(x, 1) + 1)).astype(np.int64)

    # --- degree-refined coloring ------------------------------------------
    # Splitting a color class by per-var degree keeps it a proper coloring
    # (subsets of independent sets are independent) and stops one
    # high-degree var trapped in a huge low-degree class from inflating the
    # [M, D] gather padding to O(M·deg_max) (467 MB observed at pod scale).
    deg_v = np.zeros(n_disc, np.int64)
    for e in bucket_edges:
        if e is not None:
            deg_v += np.bincount(e[1], minlength=n_disc)
    key2 = color_of.astype(np.int64) * 64 + _bits(deg_v)
    _, color_eff = np.unique(key2, return_inverse=True)
    color_eff = color_eff.astype(np.int64)
    n_colors = int(color_eff.max() + 1)
    color_of = color_eff

    # --- color classes ----------------------------------------------------
    order = np.argsort(color_of, kind="stable")
    counts = np.bincount(color_of, minlength=n_colors)
    starts = np.concatenate([[0], np.cumsum(counts)])
    tloc_of_var = np.zeros(n_disc, np.int64)
    tloc_of_var[order] = np.arange(n_disc) - starts[color_of[order]]

    # per bucket: edges sorted by target color, with per-color slices
    b_sorted = []
    for e in bucket_edges:
        if e is None:
            b_sorted.append(None)
            continue
        edge_r, edge_v, sub, w = e
        ec = color_of[edge_v]
        eo = np.argsort(ec, kind="stable")
        ecounts = np.bincount(ec, minlength=n_colors)
        estarts = np.concatenate([[0], np.cumsum(ecounts)])
        b_sorted.append(
            (edge_r[eo], edge_v[eo], sub[eo], w[eo], ecounts, estarts)
        )

    cost = np.zeros(n_colors, np.int64)
    for e in b_sorted:
        if e is not None:
            cost += e[4]

    # max per-var degree per color (bounds the [M, D] gather padding)
    dmax = np.zeros(n_colors, np.int64)
    for e in b_sorted:
        if e is None:
            continue
        _, edge_v = e[0], e[1]
        per_var = np.bincount(edge_v, minlength=n_disc)
        np.maximum.at(dmax, color_of[edge_v], per_var[edge_v])

    gkey = (_bits(cost) * 64 + _bits(counts)) * 64 + _bits(dmax)
    group_ids = {}
    for c in range(n_colors):
        group_ids.setdefault(int(gkey[c]), []).append(c)

    # padded-size guard (fall back rather than OOM the host/device)
    total_rows = 0
    for colors in group_ids.values():
        for e in b_sorted:
            if e is not None:
                total_rows += len(colors) * int(e[4][colors].max())
    if total_rows > row_cap:
        return None

    max_v = int(disc_sizes.max()) if len(disc_sizes) else 1
    if disc_vals is None:
        # fall back to index==value (true for 0..V-1 integer domains)
        disc_vals = np.broadcast_to(
            np.arange(max_v, dtype=np.float32), (n_disc, max_v)
        )
    # global values-as-indices: every latent var's first `size` values
    # are exactly 0..size-1 (padding beyond size is irrelevant)
    ar = np.arange(max_v, dtype=np.float64)
    vai = bool(
        np.all((disc_vals[:, :max_v] == ar[None, :])
               | (ar[None, :] >= disc_sizes[:, None]))
    ) if n_disc else True
    groups = []
    for _, colors in sorted(group_ids.items()):
        nc = len(colors)
        M = int(counts[colors].max())
        M = max(M, 1)
        vars_g = np.full((nc, M), n_disc, np.int64)
        sizes_g = np.ones((nc, M), np.int64)
        # when values ARE indices the sweep never reads the class value
        # table (xs['vals'] is None) — don't build or ship it at all
        # (at million-latent scale it is [nc, M, Vmax] f32 per group)
        vals_g = None if vai else np.zeros((nc, M, max_v), np.float32)
        for j, c in enumerate(colors):
            members = order[starts[c] : starts[c] + counts[c]]
            vars_g[j, : len(members)] = members
            sizes_g[j, : len(members)] = disc_sizes[members]
            if vals_g is not None:
                vals_g[j, : len(members)] = disc_vals[members, :max_v]

        tabs = []
        for np_b, e in zip(np_buckets, b_sorted):
            if e is None:
                tabs.append(None)
                continue
            edge_r, edge_v, sub, w, ecounts, estarts = e
            R = int(ecounts[colors].max())
            if R == 0:
                tabs.append(None)
                continue
            D = max(int(dmax[colors].max()), 1)
            eid = np.zeros((nc, R), np.int64)  # pad: edge 0 with w=0
            valid = np.zeros((nc, R), bool)
            # per-var gather into the color's row block: vidx[j, m, k] is
            # the position (0..R-1) of class-var m's k-th contribution row;
            # R = the appended zero row (scatter-free reduction — a [R, M]
            # one-hot einsum would be O(R·M) memory, 4.6 GB at pod scale)
            vidx = np.full((nc, M, D), R, np.int64)
            for j, c in enumerate(colors):
                k = ecounts[c]
                sl = slice(estarts[c], estarts[c] + k)
                ov = np.argsort(edge_v[sl], kind="stable")
                eid[j, :k] = np.arange(estarts[c], estarts[c] + k)[ov]
                valid[j, :k] = True
                tl = tloc_of_var[edge_v[sl][ov]]
                _, first, cnts_v = np.unique(
                    tl, return_index=True, return_counts=True
                )
                occ = np.arange(k) - np.repeat(first, cnts_v)
                vidx[j, tl, occ] = np.arange(k)
            fr = edge_r[eid]  # [nc, R] factor rows
            # value-space tables: the runtime sweep never gathers the
            # per-row [R, ad, K] value tables over a tiny minor axis (a
            # take_along_axis there materializes a 128-lane-padded copy —
            # gigabytes per color step at pod scale). Instead:
            #   disc_cval [nc, R, ad]: domain VALUE of each observed
            #     slot's baked index (latent slots read the maintained
            #     value state at runtime);
            #   sub_vals  [nc, R, Vmax]: candidate domain values of the
            #     row's target variable (all substituted slots share it).
            vals_rows = np_b["disc_vals"][fr]  # [nc, R, ad, Kb]
            # values-as-indices fast path: when every slot's domain values
            # are exactly 0..K-1 (boolean/integer MLN models — including
            # the pod-scale configs) the runtime derives values from
            # indices directly and both tables are dropped, halving the
            # plan's constant footprint at million-latent scale
            Kb = vals_rows.shape[-1]
            if np.array_equal(
                vals_rows,
                np.broadcast_to(np.arange(Kb, dtype=vals_rows.dtype),
                                vals_rows.shape),
            ):
                cval = None
                sv = None
            else:
                cval = np.take_along_axis(
                    vals_rows, np_b["disc_const"][fr][..., None].astype(
                        np.int64), axis=-1
                )[..., 0].astype(np.float32)
                sub_eid = sub[eid]  # [nc, R, ad]
                s0 = sub_eid.argmax(axis=-1)  # first substituted slot
                sv = np.take_along_axis(
                    vals_rows, s0[..., None, None], axis=2
                )[:, :, 0, :]  # [nc, R, Kb]
                if Kb < max_v:
                    sv = np.concatenate(
                        [sv, np.zeros(sv.shape[:-1] + (max_v - Kb,),
                                      sv.dtype)], axis=-1)
            tabs.append(
                {
                    "cont_idx": jnp.asarray(
                        np_b["cont_idx"][fr].astype(np.int32)
                    ),
                    "cont_mask": jnp.asarray(np_b["cont_mask"][fr]),
                    "cont_const": jnp.asarray(np_b["cont_const"][fr]),
                    "disc_idx": jnp.asarray(
                        np_b["disc_idx"][fr].astype(np.int32)
                    ),
                    "disc_mask": jnp.asarray(np_b["disc_mask"][fr]),
                    "disc_const": jnp.asarray(
                        np_b["disc_const"][fr].astype(np.int32)
                    ),
                    "disc_cval": (None if cval is None
                                  else jnp.asarray(cval)),
                    "sub_vals": (None if sv is None else jnp.asarray(
                        sv[..., :max_v].astype(np.float32))),
                    "params": {
                        k: jnp.asarray(v[fr])
                        for k, v in np_b["params"].items()
                    },
                    "sub": jnp.asarray(sub[eid]),
                    "w": jnp.asarray(
                        np.where(valid, w[eid], 0.0).astype(np.float32)
                    ),
                    "vidx": jnp.asarray(vidx.astype(np.int32)),
                }
            )
        groups.append(
            GibbsColorGroup(
                n_colors=nc,
                n_vars=M,
                vars_=jnp.asarray(vars_g.astype(np.int32)),
                sizes=jnp.asarray(sizes_g.astype(np.int32)),
                vals_=None if vals_g is None else jnp.asarray(vals_g),
                bucket_tabs=tuple(tabs),
            )
        )
    return GibbsColorPlan(groups=tuple(groups), values_are_indices=vai)


def color_plan_bytes(fg: "CompiledFG") -> dict:
    """Device-memory footprint of the compiled Gibbs color plan.

    The plan tables are REPLICATED across the mesh (only chain state is
    sharded), so this is the per-device HBM the plan costs at any device
    count — the number to budget against when sizing pod runs.

    Returns {'total_bytes': int, 'per_group': [...], 'n_groups': int}.
    """
    if fg.color_plan is None:
        return {"total_bytes": 0, "per_group": [], "n_groups": 0}
    per_group = []
    total = 0
    for grp in fg.color_plan.groups:
        leaves = jax.tree_util.tree_leaves(
            (grp.vars_, grp.sizes, grp.vals_, grp.bucket_tabs)
        )
        b = int(sum(x.size * x.dtype.itemsize for x in leaves))
        per_group.append(
            {"n_colors": grp.n_colors, "n_vars": grp.n_vars, "bytes": b}
        )
        total += b
    return {"total_bytes": total, "per_group": per_group,
            "n_groups": len(per_group)}


def _greedy_color(g: Graph, meta: FGMeta, n_disc: int) -> np.ndarray:
    """Greedy conflict coloring of discrete latent slots (two slots conflict
    if some factor touches both) → valid chromatic-Gibbs schedule."""
    adj: List[set] = [set() for _ in range(n_disc)]
    for f in g.factors:
        slots = []
        for rv in f.nb:
            kind, idx = meta.index[id(rv)]
            if kind == "d":
                slots.append(idx)
        for a in slots:
            for b in slots:
                if a != b:
                    adj[a].add(b)
    color = -np.ones(n_disc, np.int64)
    for v in range(n_disc):
        used = {color[u] for u in adj[v] if color[u] >= 0}
        c = 0
        while c in used:
            c += 1
        color[v] = c
    if n_disc == 0:
        return np.zeros(0, np.int64)
    return color
