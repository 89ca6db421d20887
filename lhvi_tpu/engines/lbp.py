"""Hybrid loopy belief propagation (reference ``HybridLBPLogVersion.py``
parity, SURVEY.md §4.5; mount empty — behavioral reconstruction).

Continuous domains are discretized at their ``Domain.integral_points``;
messages are log-space tables over each variable's support. The batched
trick: each bucket's factor table ``log φ`` over the full support product
grid is precomputed ONCE (static points), so an iteration is only

  1. variable beliefs  = segment-sum of incoming messages      (scatter-add)
  2. var→factor        = belief − incoming  (cavity)           (gather/sub)
  3. factor→var slot p = logsumexp over all grid axes except p (reshape+reduce)

— no Python edge loops, every op batched over the bucket's factor axis
(SURVEY.md §4.5 "edge sweep becomes batched segment-reduce").

Lifted mode: on a lifted IR the incoming-message sum weights each
(factor-orbit, slot) message by ``scale_f / count_v`` — the per-ground-var
edge multiplicity — which reduces to standard LBP when grounded
(scale = count = 1). One message per cluster edge, as in the reference's
lifted BP.
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


@struct.dataclass
class LBPConfig:
    n_iters: int = struct.field(pytree_node=False, default=30)
    damping: float = struct.field(pytree_node=False, default=0.2)


class _BucketTables(NamedTuple):
    log_phi: Array  # [n_f, S_0, …, S_{a-1}] factor table over support grid
    gvid: Array  # i32 [n_f, a] global var id per latent slot (0 if obs)
    lat: Array  # f32 [n_f, a] 1 = latent slot
    w_edge: Array  # f32 [n_f, a] lifted edge multiplicity scale_f/count_v


class _QueryAux(NamedTuple):
    """Per-bucket tables for re-evaluating log φ at arbitrary query points
    (reference ``belief(x, rv)`` / ``probability(x, rv)`` parity —
    SURVEY.md §4.5; mount empty)."""

    slot_vals: Array  # f32 [n_f, a, S] support values (obs slots: const)
    slot_idx: Array  # i32 [n_f, a, S] discrete value indices (0 for cont)
    slot_valid: Array  # f32 [n_f, a, S] valid support positions per slot


def _support(fg: CompiledFG):
    """Unified per-variable support table.

    Returns (sup_vals f32[n_var, S], sup_mask f32[n_var, S]) with
    continuous vars first (integral points) then discrete vars (domain
    values); S = max support size.
    """
    P = fg.cont_ipoints.shape[1] if fg.n_cont else 1
    V = fg.max_v
    S = max(P, V, 1)
    n_var = fg.n_cont + fg.n_disc
    vals = np.zeros((max(n_var, 1), S), np.float32)
    mask = np.zeros((max(n_var, 1), S), np.float32)
    # host mirrors: setup code reads no device arrays (FGMeta.np_buckets)
    cip = fg.meta.np_global["cont_ipoints"]
    dvals = fg.meta.np_global["disc_vals"]
    dsz = fg.meta.np_global["disc_sizes"]
    for i in range(fg.n_cont):
        vals[i, :P] = cip[i]
        mask[i, :P] = 1.0
    for j in range(fg.n_disc):
        vals[fg.n_cont + j, : dsz[j]] = dvals[j, : dsz[j]]
        mask[fg.n_cont + j, : dsz[j]] = 1.0
    return vals, mask  # numpy (host side); callers convert as needed


def _build_tables(fg: CompiledFG, sup_vals_np: np.ndarray,
                  sup_mask_np: np.ndarray, S: int):
    """Precompute per-bucket factor tables over the support product grid.

    Returns (tables, aux): the iteration tables plus the per-slot support
    tables needed to re-evaluate log φ at arbitrary query points.
    """
    tables: List[_BucketTables] = []
    aux_list: List[_QueryAux] = []
    for b, np_b in zip(fg.buckets, fg.meta.np_buckets):
        a = len(b.pattern)
        n_f = b.n_factors
        # per-slot support values [n_f, a, S]
        slot_vals = []
        gvid = np.zeros((n_f, a), np.int64)
        lat = np.zeros((n_f, a), np.float32)
        ci = di = 0
        cont_idx = np_b["cont_idx"]
        cont_mask = np_b["cont_mask"]
        cont_const = np_b["cont_const"]
        disc_idx = np_b["disc_idx"]
        disc_mask = np_b["disc_mask"]
        disc_const = np_b["disc_const"]
        disc_vals = np_b["disc_vals"]
        sup_np = sup_vals_np  # host mirror
        for p, is_cont in enumerate(b.pattern):
            if is_cont:
                v = np.where(
                    cont_mask[:, ci, None] > 0,
                    sup_np[np.clip(cont_idx[:, ci], 0, sup_np.shape[0] - 1)],
                    cont_const[:, ci, None],
                )
                gvid[:, p] = cont_idx[:, ci]
                lat[:, p] = cont_mask[:, ci]
                ci += 1
            else:
                dv = np.zeros((n_f, S), np.float32)
                dv[:, : disc_vals.shape[2]] = disc_vals[:, di, :]
                const_v = np.take_along_axis(
                    disc_vals[:, di, :], disc_const[:, di : di + 1], axis=1
                )
                v = np.where(disc_mask[:, di, None] > 0, dv, const_v)
                gvid[:, p] = fg.n_cont + disc_idx[:, di]
                lat[:, p] = disc_mask[:, di]
                di += 1
            slot_vals.append(v)

        # evaluate log φ on the product grid via broadcasting
        shape = (n_f,) + (S,) * a
        xc_axes, xdi_axes, xdv_axes = [], [], []
        slot_idx = np.zeros((n_f, a, S), np.int64)
        ci = di = 0
        for p, is_cont in enumerate(b.pattern):
            bshape = [n_f] + [1] * a
            bshape[1 + p] = S
            vp = slot_vals[p].reshape(bshape)
            if is_cont:
                xc_axes.append(jnp.broadcast_to(jnp.asarray(vp), shape))
                ci += 1
            else:
                # observed slots: fixed value index
                slot_idx[:, p, :] = np.where(
                    disc_mask[:, di : di + 1] > 0,
                    np.arange(S)[None, :],
                    disc_const[:, di : di + 1],
                )
                idx_grid = slot_idx[:, p, :].reshape(bshape)
                xdi_axes.append(
                    jnp.asarray(np.broadcast_to(idx_grid, shape), jnp.int32)
                )
                xdv_axes.append(jnp.broadcast_to(jnp.asarray(vp), shape))
                di += 1

        xc = (
            jnp.stack(xc_axes, axis=-1)
            if xc_axes
            else jnp.zeros(shape + (0,), jnp.float32)
        )
        xdi = (
            jnp.stack(xdi_axes, axis=-1)
            if xdi_axes
            else jnp.zeros(shape + (0,), jnp.int32)
        )
        xdv = (
            jnp.stack(xdv_axes, axis=-1)
            if xdv_axes
            else jnp.zeros(shape + (0,), jnp.float32)
        )
        params = expand_params(b.params, a)
        log_phi = b.kernel(params, xc, xdi, xdv)
        log_phi = jnp.clip(jnp.nan_to_num(log_phi, neginf=_NEG), _NEG, None)

        # mask invalid support positions of latent slots
        counts = np.concatenate(
            [fg.meta.np_global["cont_counts"], fg.meta.np_global["disc_counts"]]
        ) if (fg.n_cont + fg.n_disc) else np.ones(1)
        w_edge = np_b["scale"][:, None] / np.maximum(
            counts[np.clip(gvid, 0, max(len(counts) - 1, 0))], 1.0
        )
        slot_valid = np.zeros((n_f, a, S), np.float32)
        for p in range(a):
            m = np.where(
                lat[:, p : p + 1] > 0,
                sup_mask_np[np.clip(gvid[:, p], 0, sup_mask_np.shape[0] - 1)],
                np.concatenate(
                    [np.ones((n_f, 1)), np.zeros((n_f, S - 1))], axis=1
                ),
            )  # observed slot: only position 0 valid
            slot_valid[:, p, :] = m
            bshape = [n_f] + [1] * a
            bshape[1 + p] = S
            log_phi = jnp.where(
                jnp.asarray(m).reshape(bshape) > 0, log_phi, _NEG
            )
        tables.append(
            _BucketTables(
                log_phi=log_phi,
                gvid=jnp.asarray(gvid.astype(np.int32)),
                lat=jnp.asarray(lat),
                w_edge=jnp.asarray(w_edge.astype(np.float32)),
            )
        )
        aux_list.append(
            _QueryAux(
                slot_vals=jnp.asarray(np.stack(slot_vals, axis=1)),
                slot_idx=jnp.asarray(slot_idx.astype(np.int32)),
                slot_valid=jnp.asarray(slot_valid),
            )
        )
    return tables, aux_list


class HybridLBP:
    """Engine facade: ``HybridLBP(fg).run(iters)`` then belief queries.

    Works on grounded or lifted ``CompiledFG`` (one message per cluster
    edge in the lifted case).
    """

    def __init__(self, fg: CompiledFG):
        from lhvi_tpu.fg.compile import build_edge_gather

        self.fg = fg
        self.edge_plan = build_edge_gather(
            fg.meta.np_buckets, [b.pattern for b in fg.buckets],
            fg.n_cont, fg.n_disc,
        )
        sup_vals_np, sup_mask_np = _support(fg)
        self.sup_vals = jnp.asarray(sup_vals_np)
        self.sup_mask = jnp.asarray(sup_mask_np)
        self.sup_vals_np, self.sup_mask_np = sup_vals_np, sup_mask_np
        self.S = int(sup_vals_np.shape[1])
        self.tables, self.query_aux = _build_tables(
            fg, sup_vals_np, sup_mask_np, self.S
        )
        self.n_var = max(fg.n_cont + fg.n_disc, 1)
        self.msgs = None  # list of [n_f, a, S] per bucket
        self.beliefs_ = None

    def run(self, n_iters: int = 30, damping: float = 0.2):
        msgs = tuple(
            jnp.zeros(t.log_phi.shape[:1] + t.gvid.shape[1:] + (self.S,))
            for t in self.tables
        )
        msgs, beliefs = _lbp_iterate(
            self.tables,
            msgs,
            self.sup_mask,
            self.edge_plan,
            self.n_var,
            n_iters,
            damping,
        )
        self.msgs = msgs
        self.beliefs_ = np.asarray(beliefs)
        return self

    # --- queries ----------------------------------------------------------
    def _belief_row(self, rv):
        kind, i = self.fg.meta.loc(rv)
        if kind == "obs":
            raise ValueError(f"{rv} is observed (evidence); it has no posterior")
        row = i if kind == "c" else self.fg.n_cont + i
        b = self.beliefs_[row]
        mask = self.sup_mask_np[row] > 0
        logb = np.where(mask, b, -np.inf)
        logb = logb - logb.max()
        p = np.exp(logb) * mask
        return p / p.sum(), self.sup_vals_np[row], kind, i

    def disc_marginal(self, rv):
        p, vals, kind, i = self._belief_row(rv)
        if kind != "d":
            raise ValueError(f"{rv} is continuous")
        return p[: self.fg.meta.disc_size(rv)]

    def mean(self, rv) -> float:
        p, vals, kind, _ = self._belief_row(rv)
        return float(np.sum(p * vals))

    def var(self, rv) -> float:
        p, vals, kind, _ = self._belief_row(rv)
        m = np.sum(p * vals)
        return float(np.sum(p * (vals - m) ** 2))

    def map(self, rv):
        p, vals, kind, _ = self._belief_row(rv)
        return float(vals[int(np.argmax(p))]) if kind == "c" else (
            self.fg.meta.disc_values(rv)[
                int(np.argmax(p[: self.fg.meta.disc_size(rv)]))
            ]
        )

    # --- arbitrary-x density queries (reference ``belief(x, rv)`` /
    #     ``probability(x, rv)`` parity — SURVEY.md §4.5; mount empty) -----
    def _query_logb(self, xs: np.ndarray, row: int):
        """Log unnormalized message product at ``xs`` + grid log-normalizer.

        Both come from the same fresh (undamped, unnormalized) factor→var
        pass off the converged message state, so they share constants.
        """
        if self.msgs is None:
            raise RuntimeError("call run() before density queries")
        S = self.S
        grid_full = self.sup_vals_np[row]
        gmask = self.sup_mask_np[row] > 0
        Bj = jnp.asarray(self.beliefs_)
        bg = np.asarray(
            _lbp_query(
                self.fg, tuple(self.tables), tuple(self.query_aux),
                self.msgs, Bj, jnp.int32(row),
                jnp.asarray(grid_full, jnp.float32),
            )
        )
        bg = np.where(gmask, bg, -np.inf)
        bmax = float(bg.max())
        grid = grid_full[gmask]
        logZ = bmax + float(
            np.log(np.trapezoid(np.exp(bg[gmask] - bmax), grid))
        )
        vals = np.empty(len(xs))
        for s in range(0, len(xs), S):
            blk = xs[s : s + S]
            pad = np.pad(blk, (0, S - len(blk)), mode="edge")
            bq = np.asarray(
                _lbp_query(
                    self.fg, tuple(self.tables), tuple(self.query_aux),
                    self.msgs, Bj, jnp.int32(row),
                    jnp.asarray(pad, jnp.float32),
                )
            )
            vals[s : s + len(blk)] = bq[: len(blk)]
        return vals, logZ, bmax

    def belief(self, x, rv):
        """Normalized posterior density (continuous) / pmf (discrete) at
        caller-supplied ``x`` — evaluates the message product at ``x`` via
        a fresh factor→var pass, not a support-table lookup."""
        kind, i = self.fg.meta.loc(rv)
        if kind == "d":
            pmf = self.disc_marginal(rv)
            xs = np.atleast_1d(x)
            out = np.array(
                [pmf[self.fg.meta.value_index(rv, v)] for v in xs])
            return float(out[0]) if np.ndim(x) == 0 else out
        row = i
        xs = np.atleast_1d(np.asarray(x, np.float64))
        vals, logZ, _ = self._query_logb(xs, row)
        out = np.exp(vals - logZ)
        return float(out[0]) if np.ndim(x) == 0 else out

    def probability(self, x, rv):
        """Unnormalized message product Π m(x) at ``x`` (up to one per-run
        constant shared with the belief grid, kept for overflow safety)."""
        kind, i = self.fg.meta.loc(rv)
        if kind == "d":
            return self.belief(x, rv)
        xs = np.atleast_1d(np.asarray(x, np.float64))
        vals, _, bmax = self._query_logb(xs, i)
        out = np.exp(vals - bmax)
        return float(out[0]) if np.ndim(x) == 0 else out


@partial(jax.jit, static_argnames=("n_var", "n_iters", "damping"))
def _lbp_iterate(tables, msgs, sup_mask, plan, n_var: int, n_iters: int,
                 damping: float):
    S = sup_mask.shape[1]

    def beliefs_of(msgs):
        # scatter-free belief assembly via the precomputed edge-gather plan
        # (no scatter-adds into [n_var, S])
        if not plan.idx:
            return jnp.zeros((n_var, S))
        flats = []
        for t, m in zip(tables, msgs):
            contrib = t.w_edge[..., None] * m * t.lat[..., None]  # [n_f,a,S]
            flats.append(contrib.transpose(1, 0, 2).reshape(-1, S))
        flat = jnp.concatenate(flats + [jnp.zeros((1, S))], axis=0)
        parts = [jnp.sum(flat[idx], axis=1) for idx in plan.idx]
        return jnp.concatenate(parts, axis=0)[plan.pos_of_var]

    def one_iter(msgs, _):
        B = beliefs_of(msgs)
        new_msgs = []
        for t, m in zip(tables, msgs):
            a = t.gvid.shape[1]
            # var→factor: cavity = belief − this edge's message
            m_vf = B[t.gvid] - m  # [n_f, a, S]
            m_vf = jnp.where(t.lat[..., None] > 0, m_vf, 0.0)
            # normalize for stability
            m_vf = m_vf - jnp.max(
                jnp.where(jnp.isfinite(m_vf), m_vf, -1e9), -1, keepdims=True
            )
            # factor→var per slot: add all other slots' m_vf onto the grid,
            # reduce every axis but the slot's
            upd = []
            for p in range(a):
                g = t.log_phi
                for q in range(a):
                    if q == p:
                        continue
                    shape = [1] * g.ndim
                    shape[0] = g.shape[0]
                    shape[1 + q] = g.shape[1 + q]
                    g = g + m_vf[:, q, :].reshape(shape)
                axes = tuple(1 + q for q in range(a) if q != p)
                upd.append(
                    jax.scipy.special.logsumexp(g, axis=axes) if axes else g
                )
            m_new = jnp.stack(upd, axis=1)  # [n_f, a, S]
            m_new = m_new - jnp.max(
                jnp.where(jnp.isfinite(m_new), m_new, -1e9), -1, keepdims=True
            )
            m_new = jnp.clip(jnp.nan_to_num(m_new, neginf=_NEG), _NEG, None)
            m_new = damping * m + (1.0 - damping) * m_new
            new_msgs.append(m_new)
        return tuple(new_msgs), None

    msgs, _ = jax.lax.scan(one_iter, msgs, None, length=n_iters)
    return msgs, beliefs_of(msgs)


@jax.jit
def _lbp_query(fg: CompiledFG, tables, aux_list, msgs, B, row, xq):
    """Fresh factor→var pass for one variable at query points ``xq`` [S].

    Re-evaluates every bucket kernel with each continuous slot substituted
    by ``xq`` (other slots on their support grids), adds the converged
    cavities, reduces, and sums the edge-weighted messages of the edges
    incident to ``row``. Unnormalized and undamped, so a grid call and an
    arbitrary-x call share constants.
    """
    S = xq.shape[0]
    out = jnp.zeros(S)
    for b, t, aux, m in zip(fg.buckets, tables, aux_list, msgs):
        a = t.gvid.shape[1]
        n_f = t.gvid.shape[0]
        # var→factor cavities, normalized exactly as in the run loop
        m_vf = B[t.gvid] - m
        m_vf = jnp.where(t.lat[..., None] > 0, m_vf, 0.0)
        m_vf = m_vf - jnp.max(
            jnp.where(jnp.isfinite(m_vf), m_vf, -1e9), -1, keepdims=True
        )
        shape = (n_f,) + (S,) * a
        for p, is_cont_p in enumerate(b.pattern):
            if not is_cont_p:
                continue  # arbitrary-x queries target continuous slots only
            xc_axes, xdi_axes, xdv_axes = [], [], []
            for q, is_cont in enumerate(b.pattern):
                bshape = [n_f] + [1] * a
                bshape[1 + q] = S
                if q == p:
                    vq = jnp.broadcast_to(
                        jnp.broadcast_to(xq[None, :], (n_f, S)).reshape(bshape),
                        shape,
                    )
                else:
                    vq = jnp.broadcast_to(
                        aux.slot_vals[:, q, :].reshape(bshape), shape
                    )
                if is_cont:
                    xc_axes.append(vq)
                else:
                    xdi_axes.append(
                        jnp.broadcast_to(
                            aux.slot_idx[:, q, :].reshape(bshape), shape
                        )
                    )
                    xdv_axes.append(vq)
            xc = (
                jnp.stack(xc_axes, -1) if xc_axes
                else jnp.zeros(shape + (0,), jnp.float32)
            )
            xdi = (
                jnp.stack(xdi_axes, -1) if xdi_axes
                else jnp.zeros(shape + (0,), jnp.int32)
            )
            xdv = (
                jnp.stack(xdv_axes, -1) if xdv_axes
                else jnp.zeros(shape + (0,), jnp.float32)
            )
            params = expand_params(b.params, a)
            g = b.kernel(params, xc, xdi, xdv)
            g = jnp.clip(jnp.nan_to_num(g, neginf=_NEG), _NEG, None)
            for q in range(a):
                if q == p:
                    continue
                bshape = [n_f] + [1] * a
                bshape[1 + q] = S
                g = jnp.where(
                    aux.slot_valid[:, q, :].reshape(bshape) > 0, g, _NEG
                )
                g = g + m_vf[:, q, :].reshape(bshape)
            axes = tuple(1 + q for q in range(a) if q != p)
            mq = jax.scipy.special.logsumexp(g, axis=axes) if axes else g
            mq = jnp.clip(jnp.nan_to_num(mq, neginf=_NEG), _NEG, None)
            sel = ((t.gvid[:, p] == row) & (t.lat[:, p] > 0)).astype(mq.dtype)
            out = out + jnp.sum((t.w_edge[:, p] * sel)[:, None] * mq, axis=0)
    return out
