"""Expectation Particle Belief Propagation (reference
``EPBPLogVersion.py`` parity; Lienart et al. 2015 — SURVEY.md §4.4; mount
empty, semantics reconstructed).

Log-space particle BP: every continuous variable carries a particle set
drawn from an adaptive Gaussian proposal (moment-matched to its current
belief each iteration); discrete variables enumerate their domains.
Messages are tables over the *current* particle sets; a factor→variable
update importance-weights the sum over neighbor particle tuples:

  m_{f→v}(x) = logsumexp_{u_{-v}} [ log φ(x, u)
               + Σ_{w≠v} (cavity_w(u_w) − log q_w(u_w)) ]

Batched design: the per-slot mixed grids (target slot at NEW particles, other
slots at OLD particles) are evaluated as batched bucket tensors and reduced
with reshape+logsumexp — the O(P^|f|) hot loop of SURVEY.md §4.4 becomes a
handful of fused XLA reductions per bucket per iteration. Particle
resampling is `jax.random` keyed, so runs are replayable.

Grid axes are per-slot: continuous slots use P particle sites, discrete
slots use their true domain size, so a hybrid factor costs
O(P^n_cont · V^n_disc) instead of O(P^arity) and a large discrete domain
never forces a large particle count (support tables are
``max(P, max_v)`` wide; the valid prefix per row is P for continuous and
the domain size for discrete).
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from lhvi_tpu.utils import struct

from lhvi_tpu.fg.compile import CompiledFG, expand_params

Array = jax.Array
_NEG = -1e30


class _BucketIdx(NamedTuple):
    gvid: Array  # i32 [n_f, a] var row per slot (0 for observed)
    lat: Array  # f32 [n_f, a]
    is_cont: Array  # f32 [n_f, a] (1 for continuous slot)
    const: Array  # f32 [n_f, a] observed-slot value
    const_idx: Array  # i32 [n_f, a] observed-slot value index (discrete)
    w_edge: Array  # f32 [n_f, a]


def _index_buckets(fg: CompiledFG) -> List[_BucketIdx]:
    out = []
    # host mirrors only: setup code reads no device arrays (see
    # FGMeta.np_buckets)
    counts = (
        np.concatenate([fg.meta.np_global["cont_counts"],
                        fg.meta.np_global["disc_counts"]])
        if (fg.n_cont + fg.n_disc)
        else np.ones(1)
    )
    for b, np_b in zip(fg.buckets, fg.meta.np_buckets):
        a = len(b.pattern)
        n_f = b.n_factors
        gvid = np.zeros((n_f, a), np.int64)
        lat = np.zeros((n_f, a), np.float32)
        isc = np.zeros((n_f, a), np.float32)
        const = np.zeros((n_f, a), np.float32)
        const_idx = np.zeros((n_f, a), np.int64)
        ci = di = 0
        for p, is_cont in enumerate(b.pattern):
            if is_cont:
                gvid[:, p] = np_b["cont_idx"][:, ci]
                lat[:, p] = np_b["cont_mask"][:, ci]
                isc[:, p] = 1.0
                const[:, p] = np_b["cont_const"][:, ci]
                ci += 1
            else:
                gvid[:, p] = fg.n_cont + np_b["disc_idx"][:, di]
                lat[:, p] = np_b["disc_mask"][:, di]
                const_idx[:, p] = np_b["disc_const"][:, di]
                const[:, p] = np.take_along_axis(
                    np_b["disc_vals"][:, di, :],
                    const_idx[:, p : p + 1],
                    axis=1,
                )[:, 0]
                di += 1
        w_edge = np_b["scale"][:, None] / np.maximum(
            counts[np.clip(gvid, 0, max(len(counts) - 1, 0))], 1.0
        )
        out.append(
            _BucketIdx(
                gvid=jnp.asarray(gvid.astype(np.int32)),
                lat=jnp.asarray(lat),
                is_cont=jnp.asarray(isc),
                const=jnp.asarray(const),
                const_idx=jnp.asarray(const_idx.astype(np.int32)),
                w_edge=jnp.asarray(w_edge.astype(np.float32)),
            )
        )
    return out


def _eval_bucket_grid(b, bi: _BucketIdx, slot_vals, slot_idx,
                      sizes: tuple):
    """log φ over the product grid given per-slot support tables.

    slot_vals: [n_f, a, W] values; slot_idx: i32 [n_f, a, W] value indices
    (discrete slots); ``sizes[p]`` is slot p's grid-axis length (P for
    continuous, domain size for discrete). Returns
    [n_f, sizes[0], …, sizes[a-1]].
    """
    a = bi.gvid.shape[1]
    n_f = bi.gvid.shape[0]
    shape = (n_f,) + tuple(sizes)
    xc_axes, xdi_axes, xdv_axes = [], [], []
    for p, is_cont in enumerate(b.pattern):
        bshape = [n_f] + [1] * a
        bshape[1 + p] = sizes[p]
        vp = jnp.broadcast_to(
            slot_vals[:, p, : sizes[p]].reshape(bshape), shape
        )
        if is_cont:
            xc_axes.append(vp)
        else:
            ip = jnp.broadcast_to(
                slot_idx[:, p, : sizes[p]].reshape(bshape), shape
            )
            xdi_axes.append(ip)
            xdv_axes.append(vp)
    xc = (
        jnp.stack(xc_axes, -1) if xc_axes else jnp.zeros(shape + (0,), jnp.float32)
    )
    xdi = (
        jnp.stack(xdi_axes, -1) if xdi_axes else jnp.zeros(shape + (0,), jnp.int32)
    )
    xdv = (
        jnp.stack(xdv_axes, -1) if xdv_axes else jnp.zeros(shape + (0,), jnp.float32)
    )
    params = expand_params(b.params, a)
    lp = b.kernel(params, xc, xdi, xdv)
    return jnp.clip(jnp.nan_to_num(lp, neginf=_NEG), _NEG, None)


@struct.dataclass
class EPBPConfig:
    n_particles: int = struct.field(pytree_node=False, default=32)
    n_iters: int = struct.field(pytree_node=False, default=15)
    q_var_floor: float = struct.field(pytree_node=False, default=1e-3)


# --- message-update building blocks (shared by the run loop and the
#     arbitrary-x query pass) ------------------------------------------------

def _table_width(fg: CompiledFG, P: int) -> int:
    """Support-table width: P particle sites for continuous rows, the
    full domain for discrete rows — whichever is larger."""
    return max(P, fg.max_v, 1)


def _slot_sizes(b, P: int, max_v: int) -> tuple:
    """Per-slot grid-axis lengths for one bucket's factors."""
    return tuple(P if is_cont else max_v for is_cont in b.pattern)


def _static_tables(fg: CompiledFG, P: int):
    """(sup_idx i32[n_var,W], dmask f32[n_var,W]) support-index/valid
    tables; valid prefix is P for continuous rows, domain size for
    discrete rows."""
    W = _table_width(fg, P)
    n_var = max(fg.n_cont + fg.n_disc, 1)
    sup_idx = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None], (n_var, W))
    dmask = (
        jnp.arange(W)[None, :]
        < jnp.concatenate(
            [jnp.full(fg.n_cont, P, jnp.int32), fg.disc_sizes]
        )[:n_var, None]
    ).astype(jnp.float32)
    return sup_idx, dmask


def _slot_tables(bi: _BucketIdx, sup, sup_idx, which_new=None, sup_new=None):
    """[n_f, a, P] slot values/indices from the support table; slot
    ``which_new`` (if any) reads from ``sup_new`` instead."""
    rows = sup[bi.gvid]  # [n_f, a, P]
    if which_new is not None:
        rows = rows.at[:, which_new, :].set(sup_new[bi.gvid[:, which_new]])
    # observed slots: constant value at every position
    vals = jnp.where(bi.lat[..., None] > 0, rows, bi.const[..., None])
    idx = jnp.where(
        bi.lat[..., None] > 0,
        sup_idx[bi.gvid],
        bi.const_idx[..., None],
    )
    return vals, idx


def _log_q(fg: CompiledFG, sup, q_mu, q_var, W: int, n_var: int):
    """Per-row log-proposal at support points (0 for discrete rows)."""
    if fg.n_cont:
        lq_c = -0.5 * (
            (sup[: fg.n_cont] - q_mu[:, None]) ** 2 / q_var[:, None]
            + jnp.log(2 * jnp.pi * q_var[:, None])
        )
    else:
        lq_c = jnp.zeros((0, W))
    return jnp.concatenate([lq_c, jnp.zeros((n_var - fg.n_cont, W))], 0)


def _beliefs_of(msgs, bidx, plan, n_var: int, W: int):
    # scatter-free belief assembly (see engines.lbp)
    if not plan.idx:
        return jnp.zeros((n_var, W))
    flats = []
    for bi, m in zip(bidx, msgs):
        contrib = bi.w_edge[..., None] * m * bi.lat[..., None]
        flats.append(contrib.transpose(1, 0, 2).reshape(-1, W))
    flat = jnp.concatenate(flats + [jnp.zeros((1, W))], axis=0)
    parts = [jnp.sum(flat[idx], axis=1) for idx in plan.idx]
    return jnp.concatenate(parts, axis=0)[plan.pos_of_var]


def _update_msgs(fg, bidx, plan, dmask, sup_idx, n_var: int, P: int,
                 sup_old, msgs_old, lq_old, sup_new, normalize: bool = True):
    """One synchronous message update targeting ``sup_new`` points.

    ``normalize=False`` keeps per-edge constants intact so two passes from
    the same (sup_old, msgs_old) state — e.g. a dense grid pass and an
    arbitrary-x query pass — are on the same scale (reference
    ``probability(x, rv)`` query parity, SURVEY.md §4.4; mount empty).
    """
    W = _table_width(fg, P)
    max_v = max(fg.max_v, 1)
    B_old = _beliefs_of(msgs_old, bidx, plan, n_var, W)
    new_msgs = []
    for b, bi, m_old in zip(fg.buckets, bidx, msgs_old):
        a = bi.gvid.shape[1]
        sizes = _slot_sizes(b, P, max_v)
        cav = B_old[bi.gvid] - m_old  # [n_f, a, W] at OLD particles
        cav = cav - bi.is_cont[..., None] * (
            lq_old[bi.gvid] + jnp.log(1.0 * P)
        )
        cav = jnp.where(dmask[bi.gvid] > 0, cav, _NEG)
        cav = jnp.where(bi.lat[..., None] > 0, cav, 0.0)

        upd = []
        for p in range(a):
            vals, idx = _slot_tables(bi, sup_old, sup_idx,
                                     which_new=p, sup_new=sup_new)
            lp = _eval_bucket_grid(b, bi, vals, idx, sizes)
            for q in range(a):
                if q == p:
                    continue
                shape = [1] * lp.ndim
                shape[0] = lp.shape[0]
                shape[1 + q] = sizes[q]
                lp = lp + cav[:, q, : sizes[q]].reshape(shape)
            axes = tuple(1 + q for q in range(a) if q != p)
            red = jax.scipy.special.logsumexp(lp, axis=axes) if axes else lp
            if sizes[p] < W:  # pad the target axis back to table width
                red = jnp.pad(red, ((0, 0), (0, W - sizes[p])),
                              constant_values=_NEG)
            upd.append(red)
        m_new = jnp.stack(upd, 1)
        if normalize:
            m_new = m_new - jnp.max(
                jnp.where(jnp.isfinite(m_new), m_new, -1e9), -1, keepdims=True
            )
        m_new = jnp.clip(jnp.nan_to_num(m_new, neginf=_NEG), _NEG, None)
        new_msgs.append(m_new)
    return tuple(new_msgs)


class EPBP:
    """Engine facade mirroring the reference's ``EPBP(g).run(...)``."""

    def __init__(self, fg: CompiledFG, cfg: EPBPConfig = EPBPConfig()):
        from lhvi_tpu.fg.compile import build_edge_gather

        self.fg = fg
        self.cfg = cfg
        self.bidx = _index_buckets(fg)
        self.edge_plan = build_edge_gather(
            fg.meta.np_buckets, [b.pattern for b in fg.buckets],
            fg.n_cont, fg.n_disc,
        )
        self.state = None

    def run(self, key: Array, n_iters: int = None):
        n_iters = n_iters or self.cfg.n_iters
        out = _epbp_run(self.fg, tuple(self.bidx), self.edge_plan, key,
                        self.cfg, n_iters)
        (sup_grid, sup_idx, dmask, B, q_mu, q_var,
         sup_final, msgs_final, lq_final) = out
        self.sup, self.sup_idx, self.sup_mask, self.B, self.q_mu, self.q_var = (
            np.asarray(o) for o in
            (sup_grid, sup_idx, dmask, B, q_mu, q_var)
        )
        # final message state kept on device for arbitrary-x belief queries
        self._sup_grid_j = sup_grid
        self._sup_j = sup_final
        self._msgs_j = msgs_final
        self._lq_j = lq_final
        return self

    # --- queries ----------------------------------------------------------
    def _row(self, rv, want=None):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            raise ValueError(f"{rv} is observed (evidence); it has no posterior")
        if want and kind != want:
            raise ValueError(f"{rv} is {'continuous' if kind=='c' else 'discrete'}")
        return kind, (i if kind == "c" else self.fg.n_cont + i), i

    def _weights(self, row, kind):
        # final beliefs are tabulated on a uniform dense grid (continuous)
        # or the full domain (discrete): density ∝ exp(B)
        lw = np.where(self.sup_mask[row] > 0, self.B[row], -np.inf)
        if not np.isfinite(lw).any():
            # degenerate row (all messages underflowed): fall back to the
            # masked-uniform distribution instead of emitting NaN weights
            m = (self.sup_mask[row] > 0).astype(np.float64)
            return m / m.sum()
        lw -= lw.max()
        w = np.exp(lw) * (self.sup_mask[row] > 0)
        return w / w.sum()

    def mean(self, rv) -> float:
        kind, row, _ = self._row(rv, "c")
        w = self._weights(row, kind)
        return float(np.sum(w * self.sup[row]))

    def var(self, rv) -> float:
        kind, row, _ = self._row(rv, "c")
        w = self._weights(row, kind)
        m = np.sum(w * self.sup[row])
        return float(np.sum(w * (self.sup[row] - m) ** 2))

    def disc_marginal(self, rv):
        kind, row, i = self._row(rv, "d")
        w = self._weights(row, kind)
        return w[: self.fg.meta.disc_size(rv)]

    def map(self, rv):
        kind, row, _ = self._row(rv)
        w = self._weights(row, kind)
        if kind == "c":
            return float(self.sup[row][int(np.argmax(w))])
        return self.fg.meta.disc_values(rv)[
            int(np.argmax(w[: self.fg.meta.disc_size(rv)]))]

    # --- arbitrary-x density queries (reference ``belief(x, rv)`` /
    #     ``probability(x, rv)`` parity — SURVEY.md §4.4; mount empty) -----
    def _query_logb(self, xs: np.ndarray, row: int):
        """Log unnormalized message product at ``xs`` + grid log-normalizer."""
        P = self.cfg.n_particles
        W = _table_width(self.fg, P)
        valid = self.sup_mask[row] > 0
        grid = self.sup[row][valid]
        Brow = self.B[row][valid]
        bmax = float(Brow.max())
        logZ = bmax + float(
            np.log(np.trapezoid(np.exp(Brow - bmax), grid))
        )
        vals = np.empty(len(xs))
        for s in range(0, len(xs), P):
            blk = xs[s : s + P]
            pad = np.pad(blk, (0, W - len(blk)), mode="edge")
            bq = np.asarray(
                _epbp_query(
                    self.fg, tuple(self.bidx), self.edge_plan, self.cfg,
                    self._sup_j, self._msgs_j, self._lq_j, self._sup_grid_j,
                    row, jnp.asarray(pad, jnp.float32),
                )
            )
            vals[s : s + len(blk)] = bq[: len(blk)]
        return vals, logZ, bmax

    def belief(self, x, rv):
        """Normalized posterior density (continuous) / pmf (discrete) at
        caller-supplied ``x`` (scalar or array) — evaluates a fresh message
        pass at ``x``, not a table lookup."""
        kind, row, _ = self._row(rv)
        if kind == "d":
            pmf = self.disc_marginal(rv)
            xs = np.atleast_1d(x)
            out = np.array(
                [pmf[self.fg.meta.value_index(rv, v)] for v in xs])
            return float(out[0]) if np.ndim(x) == 0 else out
        xs = np.atleast_1d(np.asarray(x, np.float64))
        vals, logZ, _ = self._query_logb(xs, row)
        out = np.exp(vals - logZ)
        return float(out[0]) if np.ndim(x) == 0 else out

    def probability(self, x, rv):
        """Unnormalized message product Π m(x) at ``x`` (up to one per-run
        constant shared with the belief grid, kept for overflow safety)."""
        kind, row, _ = self._row(rv)
        if kind == "d":
            return self.belief(x, rv)
        xs = np.atleast_1d(np.asarray(x, np.float64))
        vals, _, bmax = self._query_logb(xs, row)
        out = np.exp(vals - bmax)
        return float(out[0]) if np.ndim(x) == 0 else out


@partial(jax.jit, static_argnames=("cfg", "n_iters"))
def _epbp_run(fg: CompiledFG, bidx, plan, key, cfg: EPBPConfig,
              n_iters: int):
    P = cfg.n_particles
    W = _table_width(fg, P)
    n_var = max(fg.n_cont + fg.n_disc, 1)

    # static support rows for discrete vars; proposal-driven for continuous
    sup_idx, dmask = _static_tables(fg, P)
    disc_rows = jnp.zeros((max(fg.n_disc, 1), W))
    if fg.n_disc:
        disc_rows = jnp.pad(fg.disc_vals, ((0, 0), (0, W - fg.max_v)))

    mid = 0.5 * (fg.cont_lo + fg.cont_hi)
    q_mu0 = mid
    q_var0 = jnp.ones(fg.n_cont) * jnp.minimum(
        (fg.cont_hi - fg.cont_lo) / 4.0, 3.0
    ) ** 2

    msgs0 = tuple(
        jnp.zeros((bi.gvid.shape[0], bi.gvid.shape[1], W)) for bi in bidx
    )

    def support_from(q_mu, q_var, kk):
        eps = jax.random.normal(kk, (max(fg.n_cont, 1), P))
        cont_rows = q_mu[:, None] + jnp.sqrt(q_var)[:, None] * eps[: fg.n_cont]
        cont_rows = jnp.pad(cont_rows, ((0, 0), (0, W - P)))  # masked tail
        return jnp.concatenate(
            [cont_rows[: fg.n_cont], disc_rows[: fg.n_disc]], axis=0
        ) if n_var == fg.n_cont + fg.n_disc and (fg.n_cont or fg.n_disc) else (
            jnp.zeros((n_var, W))
        )

    def one_iter(carry, kk):
        sup_old, msgs_old, q_mu, q_var = carry
        B_old = _beliefs_of(msgs_old, bidx, plan, n_var, W)
        lq_old = _log_q(fg, sup_old, q_mu, q_var, W, n_var)

        # refit proposals from current beliefs (importance moment matching)
        if fg.n_cont:
            lw = B_old[: fg.n_cont] - lq_old[: fg.n_cont]
            lw = jnp.where(dmask[: fg.n_cont] > 0, lw, -jnp.inf)
            lw = lw - jax.scipy.special.logsumexp(lw, 1, keepdims=True)
            w = jnp.exp(lw)
            m1 = jnp.sum(w * sup_old[: fg.n_cont], 1)
            m2 = jnp.sum(w * (sup_old[: fg.n_cont] - m1[:, None]) ** 2, 1)
            q_mu = m1
            q_var = jnp.maximum(m2, cfg.q_var_floor)

        sup_new = support_from(q_mu, q_var, kk)
        # discrete rows keep their static values
        sup_new = jnp.concatenate(
            [sup_new[: fg.n_cont], sup_old[fg.n_cont :]], axis=0
        )
        new_msgs = _update_msgs(fg, bidx, plan, dmask, sup_idx, n_var, P,
                                sup_old, msgs_old, lq_old, sup_new)
        return (sup_new, new_msgs, q_mu, q_var), None

    k0, key = jax.random.split(key)
    sup0 = support_from(q_mu0, q_var0, k0)
    carry = (sup0, msgs0, q_mu0, q_var0)
    carry, _ = jax.lax.scan(
        one_iter, carry, jax.random.split(key, n_iters)
    )
    sup, msgs, q_mu, q_var = carry

    # Rao-Blackwellized final pass: evaluate messages on a deterministic
    # dense grid per continuous var (reference "probability(x, rv)" query
    # parity) — kills most single-particle-set MC noise in the queries.
    if fg.n_cont:
        t = jnp.linspace(0.0, 1.0, P)[None, :]
        span = 4.0 * jnp.sqrt(q_var)
        lo = jnp.maximum(q_mu - span, fg.cont_lo)
        hi = jnp.minimum(q_mu + span, fg.cont_hi)
        grid_rows = lo[:, None] + (hi - lo)[:, None] * t
        grid_rows = jnp.pad(grid_rows, ((0, 0), (0, W - P)))  # masked tail
        sup_grid = jnp.concatenate([grid_rows, sup[fg.n_cont :]], axis=0)
    else:
        sup_grid = sup
    lq = _log_q(fg, sup, q_mu, q_var, W, n_var)
    # UNNORMALIZED grid pass: shares per-edge constants with any later
    # arbitrary-x query pass from the same (sup, msgs, lq) state.
    msgs_grid = _update_msgs(fg, bidx, plan, dmask, sup_idx, n_var, P,
                             sup, msgs, lq, sup_grid, normalize=False)
    B = _beliefs_of(msgs_grid, bidx, plan, n_var, W)
    return sup_grid, sup_idx, dmask, B, q_mu, q_var, sup, msgs, lq


@partial(jax.jit, static_argnames=("cfg",))
def _epbp_query(fg: CompiledFG, bidx, plan, cfg: EPBPConfig,
                sup, msgs, lq, sup_grid, row, xq):
    """Belief row at caller-supplied points ``xq`` [W] for variable ``row``
    (only the first P entries are evaluated for a continuous target).

    Runs one unnormalized message pass from the final EPBP state targeting
    the grid support with ``row`` replaced by ``xq`` — same constants as
    the stored grid beliefs, so exp(B_q − logZ_grid) is the density.
    """
    P = cfg.n_particles
    W = _table_width(fg, P)
    n_var = max(fg.n_cont + fg.n_disc, 1)
    sup_idx, dmask = _static_tables(fg, P)
    sup_q = sup_grid.at[row].set(xq)
    msgs_q = _update_msgs(fg, bidx, plan, dmask, sup_idx, n_var, P,
                          sup, msgs, lq, sup_q, normalize=False)
    return _beliefs_of(msgs_q, bidx, plan, n_var, W)[row]
