"""Banded (DIA) form of the sparse quadratic target.

Grid/chain/banded information matrices have a handful of DIAGONALS:
J x = diag·x + Σ_k w_k · shift(x, o_k) for a small static offset set
{o_k}. The matvec is then K static shift-multiply-accumulates with no
gathers, where the ELL form (``ops.leapfrog.ell_matvec``) gathers D
neighbours per row. Whether DIA earns its place beside ELL on the GPU is
an open design question (ROADMAP design item 2); ``HMCConfig.dia_kernel``
switches between the two.

Correctness of the circular roll: an entry ``w_k[i] ≠ 0`` implies the
edge (i, i+o_k) exists, hence ``0 ≤ i+o_k < n`` — every wrapped-around
lane is multiplied by a structural zero, so no masking is needed
(asserted by construction in ``ell_to_dia``).

The reference (SURVEY.md §3.1) has no sparse-matrix machinery at all —
its dense Gaussian tooling stops at a few thousand variables.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


def ell_to_dia(col: np.ndarray, w: np.ndarray, pos: np.ndarray = None,
               max_offsets: int = 8):
    """Detect a banded structure in padded-neighbor (ELL) tables.

    col/w: [n, D] neighbor tables (``CompiledFG.quad_ell_col/_w``).
    pos: optional i32 [n] EMBEDDING of each latent into a larger banded
    coordinate space — evidence conditioning compacts latent indices, so
    a grid with observed nodes has irregular latent-index offsets, while
    its declaration-order positions (latents + observed interleaved)
    keep the {±1, ±W} template; the embedded vector simply carries inert
    zero lanes at evidence positions.

    Returns ``(offsets, wdia, pos)`` — a static tuple of K ≤ max_offsets
    diagonal offsets, the f32 [K, n_emb] per-diagonal weights with
    ``(J x)[pos[i]] = Σ_k wdia[k, pos[i]]·x_emb[pos[i] + offsets[k]]``
    (diagonal handled separately), and the embedding (``None`` when it
    is the identity) — or ``None`` when the active offsets don't fit the
    budget (then the ELL gather path stands). Grid MRFs yield K=4
    ({±1, ±W}); chains K=2.
    """
    col = np.asarray(col)
    w = np.asarray(w, np.float32)
    n, D = col.shape
    if n == 0:
        return None
    if pos is not None:
        pos = np.asarray(pos, np.int64)
        if np.array_equal(pos, np.arange(n)):
            pos = None
    if pos is None:
        n_emb = n
        posv = np.arange(n, dtype=np.int64)
    else:
        n_emb = int(pos.max()) + 1
        posv = pos
    offs = posv[col] - posv[:, None]  # [n, D] embedded-coordinate offsets
    active = w != 0.0
    if not active.any():
        return (), np.zeros((0, n_emb), np.float32), pos
    uoffs = np.unique(offs[active])
    if len(uoffs) > max_offsets:
        return None
    wdia = np.zeros((len(uoffs), n_emb), np.float32)
    for k, o in enumerate(uoffs):
        contrib = np.where(active & (offs == o), w, 0.0).sum(axis=1)
        np.add.at(wdia[k], posv, contrib)
        # structural-zero invariant that makes the circular roll exact
        i = np.flatnonzero(wdia[k])
        assert i.size == 0 or (0 <= i.min() + o and i.max() + o < n_emb)
    return tuple(int(o) for o in uoffs), wdia, pos


def _embed(a, pos, n_emb: int):
    """Scatter latent-space rows [..., n] into the declaration-order
    embedded space [..., n_emb] (inert zeros at evidence positions)."""
    return jnp.zeros(a.shape[:-1] + (n_emb,), a.dtype).at[..., pos].set(a)


def pos_to_inv(pos: np.ndarray, n: int) -> np.ndarray:
    """Inverse embedding index: i32 [n_emb] mapping each embedded lane to
    its latent index, with the sentinel ``n`` at gap (evidence) lanes —
    lets ``_embed_gather`` express the scatter as a GATHER."""
    pos = np.asarray(pos)
    n_emb = int(pos.max()) + 1
    inv = np.full(n_emb, n, np.int32)
    inv[pos] = np.arange(n, dtype=np.int32)
    return inv


def _embed_gather(a, inv):
    """Gather-based embedding: append one zero column and index by the
    inverse map (gaps hit the sentinel column)."""
    az = jnp.concatenate([a, jnp.zeros(a.shape[:-1] + (1,), a.dtype)],
                         axis=-1)
    return az[..., inv]


def dia_matvec(x, diag, offsets, wdia, pos=None):
    """``J @ x`` for a batch in DIA form: x [C, n] → [C, n] (pure XLA).

    Shift-multiply-accumulate over the K static diagonals; the circular
    roll is exact because out-of-range lanes carry structural zeros in
    ``wdia`` (see module docstring). ``pos`` embeds/extracts around the
    shifts when the weights live in declaration-order coordinates.
    """
    if pos is not None:
        n_emb = wdia.shape[1]
        y = _embed(x * diag[None], pos, n_emb)
        xe = _embed(x, pos, n_emb)
    else:
        y = x * diag[None]
        xe = x
    for k, o in enumerate(offsets):
        y = y + wdia[k][None] * jnp.roll(xe, -o, axis=-1)
    return y[..., pos] if pos is not None else y


def _lp(x, h, g):
    """½·Σ x·(h+g) — the pure-quadratic log-potential up to the constant
    (lp = c + ½·x·(h + g) with g = h − Jx)."""
    return 0.5 * jnp.sum(x * (h[None] + g), axis=-1)


def _jnp_dia_leapfrog(x, p, diag, offsets, wdia, h, inv_mass, eps,
                      n_steps: int):
    """Same position-Verlet composition as
    ``ops.leapfrog.ell_quad_leapfrog`` with the DIA matvec. Returns
    ``(x1, p1, lp0, lp1)`` — endpoint log-potentials (sans constant)
    instead of gradients."""

    def matvec(x):
        return dia_matvec(x, diag, offsets, wdia)

    g0 = h[None] - matvec(x)
    lp0 = _lp(x, h, g0)
    if n_steps == 0:
        return x, p, lp0, lp0
    m = p + 0.5 * eps * g0

    def body(_, carry):
        x, m = carry
        x = x + eps * inv_mass[None] * m
        g = h[None] - matvec(x)
        m = m + eps * g
        return x, m

    x, m = jax.lax.fori_loop(0, n_steps - 1, body, (x, m))
    x = x + eps * inv_mass[None] * m
    g1 = h[None] - matvec(x)
    p1 = m + 0.5 * eps * g1
    return x, p1, lp0, _lp(x, h, g1)


def dia_quad_leapfrog(x, p, diag, offsets, wdia, h, inv_mass, eps,
                      n_steps: int, pos=None):
    """Batched leapfrog on a BANDED quadratic target.

    Returns ``(x1, p1, lp0, lp1)`` — endpoint positions/momenta plus the
    endpoint log-potentials WITHOUT the constant (lp = ½·x·(h+g); add
    ``quad_c`` outside; it cancels in the MH ratio anyway).

    ``pos`` (declaration-order embedding) is applied ONCE around the whole
    trajectory: the integrator runs in the embedded space, where evidence
    lanes are inert (diag = h = im = 0 → zero gradient and zero drift) and
    contribute nothing to lp, so the per-proposal embedding cost is one
    scatter + two gathers, not one per step.
    """
    if pos is not None:
        n_emb = wdia.shape[1]
        x = _embed(x, pos, n_emb)
        p = _embed(p, pos, n_emb)
        diag = _embed(diag, pos, n_emb)
        h = _embed(h, pos, n_emb)
        inv_mass = _embed(inv_mass, pos, n_emb)
    out = _jnp_dia_leapfrog(x, p, diag, offsets, wdia, h, inv_mass, eps,
                            n_steps)
    if pos is not None:
        # lp is embedding-invariant (gap lanes are zero); only the state
        # arrays gather back to latent coordinates
        out = (out[0][..., pos], out[1][..., pos], out[2], out[3])
    return out


def dia_hmc_proposal(k_mom, xc, diag, offsets, wdia, h, inv_mass, eps,
                     n_steps: int, pos=None, inv=None):
    """One full HMC proposal on a banded target: sample momenta,
    integrate the whole trajectory, return ``(x1 [C, n], log_acc [C])``.

    Everything between the RNG draw and the accept test runs in EMBEDDED
    coordinates, so the per-proposal embedding cost is ONE gather of x in
    and one gather of x1 out — momenta are sampled directly in embedded
    space (their gap lanes get std 0 via the zero inv_mass lanes), the
    kinetic energies reduce over embedded arrays (gap lanes contribute 0),
    and the log-potentials come back from the integrator. The quad
    constant cancels in the ratio. All embeds are gathers via ``inv``
    (``pos_to_inv``) rather than scatters.
    """
    if pos is not None:
        x = _embed_gather(xc, inv)
        diag = _embed_gather(diag, inv)
        h = _embed_gather(h, inv)
        im = _embed_gather(inv_mass, inv)
    else:
        x, im = xc, inv_mass
    # gap lanes: im = 0 → std = 0 → momentum 0 → lane inert end-to-end
    std = jnp.where(im > 0, jnp.sqrt(1.0 / jnp.maximum(im, 1e-12)), 0.0)
    p0 = std[None, :] * jax.random.normal(k_mom, x.shape)
    x1, p1, lp0, lp1 = _jnp_dia_leapfrog(x, p0, diag, offsets, wdia, h, im,
                                         eps, n_steps)
    ke = lambda p: 0.5 * jnp.sum(im[None, :] * p * p, axis=-1)
    log_acc = jnp.minimum(0.0, (lp1 - lp0) + (ke(p0) - ke(p1)))
    log_acc = jnp.where(jnp.isfinite(log_acc), log_acc, -jnp.inf)
    if pos is not None:
        x1 = x1[..., pos]
    return x1, log_acc
