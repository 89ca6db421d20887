"""Collapsed orbit-flip MH move: unlocks mode-locked discrete blocks.

Why this exists (discrete mode-locking):
on the pod flagship (SURVEY.md §1 config 5, friends-smokers MLN) the
``friends(X,Y) ⇒ (smokes(X) ⇔ smokes(Y))`` couplings ground to a
ferromagnetic clique over the free ``smokes`` latents. A single-site flip
against the clique faces an energy barrier of roughly ``w · degree``
(~40 nats at 40 people), so every chain freezes the whole block at its
initialization-chosen joint mode: the streamed ``rhat_disc`` saturates
(W=0, B>0 → R̂ ~ 5e5) on exactly those variables, and because the joint
modes are NOT equal in mass once the stress/cancer couplings adapt,
chains stuck in the minor mode bias pooled marginals.

A plain block flip of the clique is not enough (measured: 0 accepted
flips on the locked block) — the neighboring ``friends``/``cancer``
states anchor the current mode with O(100) nats of mismatch. The move
that works is the COLLAPSED flip:

  1. **Group** ``G``: a class of the same IR color refinement the
     lifting machinery uses (``lift.fast.refine_ir``), kept only when
     its members co-occur in at least one factor row — intra-coupled
     blocks are the only ones that can mode-lock (a group whose members
     never share a factor has conditionally independent members, which
     single-site Gibbs already mixes).
  2. **Proposal**: apply one uniformly-chosen value transposition
     ``a ↔ b`` to every member of ``G`` (an involution with a
     state-independent pair probability ⇒ no Hastings factor from this
     part), then redraw a precomputed independent set ``F`` of G's
     discrete neighbors from their exact full conditionals given the
     flipped block (the same per-variable logits chromatic Gibbs uses).
  3. **Accept** with the collapsed ratio: because no factor row touches
     two members of ``F``, the joint conditional of ``F`` factorizes and
     the Hastings ratio telescopes to

         π̃(g')/π̃(g),   log π̃(g) = Σ_{f∈F} logsumexp_v β·logit_f(v; g)
                                    + β · direct(g)

     where ``direct`` sums the factor rows touching no ``F`` member —
     i.e. the anchoring neighbors are *summed out* rather than dragged
     along. Exactness does not depend on ``G`` being a true automorphism
     orbit or on ``F`` being maximal: each group step is a valid MH
     kernel for any fixed grouping; orbits only make acceptance high.

A chain stuck in the minor mode accepts the uphill collapsed flip almost
surely on the first proposal; the reverse move accepts with the correct
Boltzmann frequency, so pooled marginals land on the true mode weights.

Program shape: one ``lax.scan`` over G groups; each step is two fused
all-rows conditional-logit passes (``CompiledFG.disc_logits``, vmapped
over chains), two masked bucket-kernel sums, and ``[C]``-row ``where``s.
No scatters, static shapes; GSPMD partitions the chain axis natively.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from lhvi_tpu.utils import struct

from lhvi_tpu.fg.compile import CompiledFG

Array = jax.Array
_NEG_BIG = -1e30


@struct.dataclass
class ModeSwapPlan:
    """Static per-group data for the collapsed orbit-flip move.

    ``vars_[g]`` holds the group's global discrete ids padded with
    ``n_disc``; ``vmax[g]`` the shared domain size (orbit members share a
    domain — refinement seeds on domain identity); ``f_mask[g]`` marks
    the group's collapsed independent neighbor set; ``w_direct`` carries
    row weights for the direct term of the buckets in ``direct_buckets``
    stacked ``[G, R]`` — only rows touching G but no F member (rows
    touching F live inside the F logits; rows touching neither G nor F
    cancel in the accept delta), with all-zero buckets dropped statically
    (on the pod model this shrinks the direct evaluation from ~300k rows
    to the 320 stress-link rows).
    """

    n_groups: int = struct.field(pytree_node=False)
    n_vars: int = struct.field(pytree_node=False)  # padded group width
    direct_buckets: Tuple = struct.field(pytree_node=False, default=())
    # static: any group has a non-empty F? Self-contained cliques (all
    # neighbors inside the group) collapse nothing — the sweep then skips
    # both full conditional-logit passes, its dominant cost
    has_f: bool = struct.field(pytree_node=False, default=True)
    vars_: Array = None  # i32 [G, M] (pad = n_disc)
    vmax: Array = None  # i32 [G]
    f_mask: Array = None  # bool [G, n_disc]
    w_direct: Tuple = ()  # per kept bucket f32 [G, R]


def _row_latents(np_b):
    """(real_row_idx, disc_idx[real], latent_mask[real]) for one host
    bucket mirror."""
    real = np.nonzero(np_b["scale"] > 0)[0]
    return real, np_b["disc_idx"][real], np_b["disc_mask"][real] > 0


# plan cache keyed by the graph's (identity-hashed) meta: engines call
# build via run_hmc/run_nuts/run_smc on every dispatch, and the host-side
# refinement costs seconds at pod scale — build once per compiled model.
# WeakKey so a dropped model releases its plan arrays.
_PLAN_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_NO_PLAN = object()


def plan_for(fg: CompiledFG) -> Optional[ModeSwapPlan]:
    """Cached ``build_mode_swap_plan(fg)`` (default parameters)."""
    hit = _PLAN_CACHE.get(fg.meta)
    if hit is None:
        hit = build_mode_swap_plan(fg)
        _PLAN_CACHE[fg.meta] = hit if hit is not None else _NO_PLAN
    return None if hit is _NO_PLAN else hit


def build_mode_swap_plan(
    fg: CompiledFG,
    min_size: int = 2,
    max_groups: int = 8,
) -> Optional[ModeSwapPlan]:
    """Build the collapsed-flip plan for ``fg`` (host-side, one-time).

    Groups are the discrete classes of the IR color refinement, kept when
    they have ≥ ``min_size`` members, a domain with ≥ 2 values, and at
    least one real factor row containing two members (the mode-locking
    signature), largest first up to ``max_groups``. Returns ``None`` when
    nothing qualifies — callers skip the move and models without
    symmetric intra-coupled blocks pay nothing.
    """
    if fg.n_disc == 0:
        return None
    from lhvi_tpu.lift.fast import refine_ir

    _, vcol_d, _ = refine_ir(fg)
    sizes = np.asarray(fg.meta.np_global["disc_sizes"], np.int64)
    np_bs = fg.meta.np_buckets

    # host adjacency (latent–latent co-occurrence) + per-group intra test
    pairs = []
    for np_b in np_bs:
        _, didx, dlat = _row_latents(np_b)
        a = didx.shape[1] if didx.ndim == 2 else 0
        for p in range(a):
            for q in range(p + 1, a):
                m = dlat[:, p] & dlat[:, q]
                if m.any():
                    pairs.append(
                        np.stack([didx[m, p], didx[m, q]], axis=1))
    if pairs:
        pr = np.concatenate(pairs, axis=0).astype(np.int64)
        pr = pr[pr[:, 0] != pr[:, 1]]
        lo = np.minimum(pr[:, 0], pr[:, 1])
        hi = np.maximum(pr[:, 0], pr[:, 1])
        enc = np.unique(lo * fg.n_disc + hi)
        lo, hi = enc // fg.n_disc, enc % fg.n_disc
        # symmetric CSR adjacency
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        starts = np.searchsorted(src, np.arange(fg.n_disc + 1))
    else:
        dst = np.zeros(0, np.int64)
        starts = np.zeros(fg.n_disc + 1, np.int64)

    def neighbors(v):
        return dst[starts[v]:starts[v + 1]]

    def classes_of(labels):
        order_ = np.argsort(labels, kind="stable")
        _, grp_starts = np.unique(labels[order_], return_index=True)
        return [g for g in np.split(order_, grp_starts[1:])
                if len(g) >= min_size and sizes[g[0]] >= 2]

    def intra_coupled(classes):
        # mode-locking signature: two members share a factor row
        out = []
        for g in classes:
            gset = np.zeros(fg.n_disc, bool)
            gset[g] = True
            if any(gset[neighbors(v)].any() for v in g):
                out.append(g)
        return out

    groups = intra_coupled(classes_of(vcol_d))
    if not groups:
        # refinement can shatter a genuinely symmetric block when the
        # grounding is ordered (slot positions differ per member even
        # under a symmetric potential). Fall back to the coarse
        # domain-signature partition — coarser groups only lower
        # acceptance, never exactness (any fixed grouping is a valid MH
        # kernel)
        vals = np.asarray(fg.meta.np_global["disc_vals"], np.float64)
        sig = np.array(
            [hash((int(sizes[i]),
                   tuple(np.round(vals[i], 6).tolist())))
             for i in range(fg.n_disc)]
        )
        groups = intra_coupled(classes_of(sig))
    if not groups:
        return None
    groups.sort(key=len, reverse=True)
    groups = groups[:max_groups]

    G = len(groups)
    m = max(len(g) for g in groups)
    vars_ = np.full((G, m), fg.n_disc, np.int32)
    vmax = np.zeros(G, np.int32)
    f_mask = np.zeros((G, fg.n_disc), bool)
    for i, g in enumerate(groups):
        vars_[i, : len(g)] = g
        gs = sizes[g]
        assert (gs == gs[0]).all(), "orbit members must share a domain"
        vmax[i] = gs[0]
        gset = np.zeros(fg.n_disc, bool)
        gset[g] = True
        # F: greedy maximal independent subset of G's neighbors — no two
        # F members may share ANY factor row, or the collapsed product
        # would not factorize
        cand = np.unique(np.concatenate([neighbors(v) for v in g])) \
            if len(g) else np.zeros(0, np.int64)
        cand = cand[~gset[cand]]
        blocked = np.zeros(fg.n_disc, bool)
        for f in cand:
            if blocked[f]:
                continue
            f_mask[i, f] = True
            blocked[neighbors(f)] = True

    # direct-term row weights: only rows touching G but no F member
    # survive (F-touching rows live inside the F logits; rows touching
    # neither G nor F are identical on both sides of the accept delta and
    # are dropped for speed, which is exact); buckets all-zero across
    # groups are dropped statically
    direct_buckets, w_direct = [], []
    for bi in fg.disc_bucket_idx:
        np_b = np_bs[bi]
        scale = np.asarray(np_b["scale"], np.float32)
        didx = np_b["disc_idx"]
        dlat = np_b["disc_mask"] > 0
        didx_l = np.where(dlat, didx, fg.n_disc)
        w = np.broadcast_to(scale, (G,) + scale.shape).copy()
        for i, g in enumerate(groups):
            fm = np.concatenate([f_mask[i], np.zeros(1, bool)])
            gm = np.zeros(fg.n_disc + 1, bool)
            gm[g] = True
            w[i, fm[didx_l].any(axis=1)] = 0.0
            w[i, ~gm[didx_l].any(axis=1)] = 0.0
        if (w != 0.0).any():
            direct_buckets.append(bi)
            w_direct.append(jnp.asarray(w))

    return ModeSwapPlan(
        n_groups=G,
        n_vars=m,
        direct_buckets=tuple(direct_buckets),
        has_f=bool(f_mask.any()),
        vars_=jnp.asarray(vars_),
        vmax=jnp.asarray(vmax),
        f_mask=jnp.asarray(f_mask),
        w_direct=tuple(w_direct),
    )


def _direct_lp(fg: CompiledFG, xc: Array, xd: Array, w_tabs,
               bucket_idx) -> Array:
    """``[C]`` Σ_rows w·log φ over the plan's kept buckets with its
    per-group row weights (only G-touching, F-free rows carry weight)."""
    total = jnp.zeros((xd.shape[0],), jnp.float32)
    for w, bi in zip(w_tabs, bucket_idx):
        b = fg.buckets[bi]
        params, xcs, xdi, xdv = b.gather_args_batched(xc, xd)
        lp = b.kernel(params, xcs, xdi, xdv)  # [C, R]
        # hard-formula rows are legitimately -inf; zero-weight rows must
        # not turn 0·(-inf) into NaN
        total = total + jnp.sum(
            w[None] * jnp.nan_to_num(lp, neginf=_NEG_BIG), axis=-1)
    return total


def mode_swap_sweep(
    fg: CompiledFG,
    key: Array,
    xc: Array,
    xd: Array,
    plan: ModeSwapPlan,
    beta=1.0,
):
    """One collapsed-flip MH pass over the plan's groups for all chains.

    ``xc [C, n_cont]``, ``xd [C, n_disc]`` → ``(xd', accept_mean)``.
    ``accept_mean`` averages per-chain accepts over groups — on a model
    whose modes differ strongly in mass it settles near the minor-mode
    weight once every chain sits in the major mode (the diagnostic that
    matters is ``rhat_disc`` deflating, not this number being large).

    ``beta`` tempers logits and direct terms exactly like the tempered
    Gibbs sweep (SMC rejuvenation targets ``π^β``); the collapsed sums
    are then over ``(π^β)``'s conditionals, which is the consistent
    collapse for that target.
    """
    C = xd.shape[0]
    V = fg.max_v
    valid = (jnp.arange(V, dtype=jnp.int32)[None, :]
             < fg.disc_sizes[:, None])  # [n_disc, V]

    if fg.color_plan is not None:
        # per-color scanned assembly: identical logits, but peak memory
        # per step is one color class's adjacent rows — the all-rows
        # disc_logits pass materializes [C, R, V, ad] candidate tensors
        # per slot, too large for device memory at pod scale
        from lhvi_tpu.engines.hmc import planned_logits

        logits_fn = lambda c, d: planned_logits(fg, c, d)
    else:
        logits_fn = fg.disc_logits

    def temper(L):
        # apply β then re-mask: β=0 must not resurrect invalid values
        return jnp.where(valid[None], beta * L, _NEG_BIG)

    def body(xd, inp):
        k, gvars, v, fmask, wtabs = inp
        ka, kb, ku, kr = jax.random.split(k, 4)
        # uniform unordered value pair {a, b} PER CHAIN: involutive,
        # state-independent proposal probability — symmetric. Per-chain
        # pairs keep chains independent draws of the kernel on V>2
        # domains (a shared pair would positively correlate chains and
        # bias split-R̂'s between-chain variance low); on binary domains
        # every chain's pair is {0, 1} regardless
        a = jax.random.randint(ka, (C,), 0, v)
        b_ = (a + 1 + jax.random.randint(kb, (C,), 0, v - 1)) % v
        member = (
            jnp.zeros(fg.n_disc + 1, bool).at[gvars].set(True)[: fg.n_disc]
        )
        a_, bb = a[:, None], b_[:, None]
        swapped = jnp.where(xd == a_, bb, jnp.where(xd == bb, a_, xd))
        xd_p = jnp.where(member[None], swapped, xd)

        if plan.has_f:
            L = temper(jax.vmap(logits_fn)(xc, xd))  # [C, n_disc, V]
            Lp = temper(jax.vmap(logits_fn)(xc, xd_p))
            lse = jax.scipy.special.logsumexp
            S = jnp.sum(fmask[None] * lse(L, axis=-1), axis=-1)  # [C]
            Sp = jnp.sum(fmask[None] * lse(Lp, axis=-1), axis=-1)
        else:
            # self-contained groups collapse nothing — skip the two
            # full-conditional passes (the move's dominant cost)
            S = Sp = jnp.zeros((C,))
        d0 = _direct_lp(fg, xc, xd, wtabs, plan.direct_buckets)
        d1 = _direct_lp(fg, xc, xd_p, wtabs, plan.direct_buckets)
        delta = (Sp - S) + beta * (d1 - d0)
        acc = jnp.log(jax.random.uniform(ku, (C,))) < delta
        xd_out = jnp.where(acc[:, None] & member[None], xd_p, xd)
        if plan.has_f:
            # accepted chains: F redrawn from the flipped-state
            # conditionals (the proposal the ratio above collapsed over)
            f_new = jax.random.categorical(kr, Lp, axis=-1).astype(
                jnp.int32)
            xd_out = jnp.where(acc[:, None] & fmask[None], f_new, xd_out)
        return xd_out, jnp.mean(acc.astype(jnp.float32))

    keys = jax.random.split(key, plan.n_groups)
    xd, accs = jax.lax.scan(
        body, xd,
        (keys, plan.vars_, plan.vmax, plan.f_mask, plan.w_direct),
    )
    return xd, jnp.mean(accs)


def maybe_mode_swap(fg: CompiledFG, cfg, key: Array, xc: Array,
                    xd: Array):
    """The transition-level entry: apply the sweep with probability
    ``1/cfg.mode_swap_every`` (a random-scan mixture kernel — exactness
    is unaffected, and ``lax.cond`` skips the two logit passes on gated
    transitions, amortizing the move's cost; a stuck chain accepts the
    uphill swap on its first proposal, so once every few transitions is
    plenty). Returns ``(xd, accept_mean, n_applied)`` — the accumulator
    increments only when the move ran, so ``diag["mode_swap_accept"]``
    stays a true per-application acceptance."""
    every = max(1, int(getattr(cfg, "mode_swap_every", 1)))
    k_gate, k_ms = jax.random.split(key)
    if every == 1:
        xd, acc = mode_swap_sweep(fg, k_ms, xc, xd, fg.mode_swap_plan)
        return xd, acc, jnp.ones(())
    gate = jax.random.uniform(k_gate, ()) * every < 1.0
    return jax.lax.cond(
        gate,
        lambda xd: (*mode_swap_sweep(fg, k_ms, xc, xd, fg.mode_swap_plan),
                    jnp.ones(())),
        lambda xd: (xd, jnp.zeros(()), jnp.zeros(())),
        xd,
    )
