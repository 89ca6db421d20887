"""Banded (DIA) refinement of the ELL sparse path.

The detector must reproduce the ELL matvec exactly (including the
declaration-order embedding that undoes evidence compaction); the DIA
leapfrog must match the ELL leapfrog, the fused proposal must match its
unfused composition; and HMC through the DIA path must still recover the
exact oracle.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lhvi_tpu import compile_graph
from lhvi_tpu.engines import hmc
from lhvi_tpu.models.toy import gaussian_grid
from lhvi_tpu.ops import dia
from lhvi_tpu.ops.leapfrog import ell_matvec, ell_quad_leapfrog


@pytest.fixture(scope="module")
def grid_fg():
    g, _ = gaussian_grid(rows=16, cols=16, seed=0, evidence_frac=0.15)
    fgd = compile_graph(g, quad_max_n=10_000)   # dense (oracle)
    fgs = compile_graph(g, quad_max_n=64)       # forced ELL + DIA
    assert fgs.quad_sparse
    return g, fgd, fgs


def test_grid_compiles_to_dia(grid_fg):
    _, _, fgs = grid_fg
    assert fgs.quad_dia_offsets is not None
    # in declaration-order coordinates the evidence grid keeps the
    # row-major template exactly
    assert set(fgs.quad_dia_offsets) == {-16, -1, 1, 16}
    # evidence compaction means the embedding is non-trivial here
    assert fgs.quad_dia_pos is not None
    n_emb = fgs.quad_dia_w.shape[1]
    assert n_emb == 256 and fgs.n_cont < 256
    assert fgs.quad_dia_w.shape == (4, n_emb)


def test_dia_matvec_matches_ell(grid_fg):
    _, _, fgs = grid_fg
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(7, fgs.n_cont)), jnp.float32)
    ref = ell_matvec(x, fgs.quad_diag, fgs.quad_ell_col, fgs.quad_ell_w)
    got = dia.dia_matvec(x, fgs.quad_diag, fgs.quad_dia_offsets,
                         fgs.quad_dia_w, fgs.quad_dia_pos)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_dia_leapfrog_matches_ell(grid_fg):
    _, _, fgs = grid_fg
    rng = np.random.default_rng(1)
    n = fgs.n_cont
    x = jnp.asarray(rng.normal(size=(5, n)), jnp.float32)
    p = jnp.asarray(rng.normal(size=(5, n)), jnp.float32)
    im = jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)
    rx, rp, rg0, rg1 = ell_quad_leapfrog(
        x, p, fgs.quad_diag, fgs.quad_ell_col, fgs.quad_ell_w,
        fgs.quad_h, im, 0.05, 8)
    hq = fgs.quad_h[None]
    ref = (rx, rp, 0.5 * jnp.sum(x * (hq + rg0), -1),
           0.5 * jnp.sum(rx * (hq + rg1), -1))
    got = dia.dia_quad_leapfrog(x, p, fgs.quad_diag, fgs.quad_dia_offsets,
                                fgs.quad_dia_w, fgs.quad_h, im, 0.05, 8,
                                pos=fgs.quad_dia_pos)
    for a, b, name in zip(got, ref, ("x1", "p1", "lp0", "lp1")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-3, err_msg=name)
    # n_steps=0 is a no-op (same guard as the ELL path)
    x0, p0, la, lb = dia.dia_quad_leapfrog(
        x, p, fgs.quad_diag, fgs.quad_dia_offsets, fgs.quad_dia_w,
        fgs.quad_h, im, 0.05, 0, pos=fgs.quad_dia_pos)
    assert np.array_equal(np.asarray(x0), np.asarray(x))
    assert np.array_equal(np.asarray(p0), np.asarray(p))
    assert np.array_equal(np.asarray(la), np.asarray(lb))


def test_dia_proposal_matches_unfused(grid_fg):
    """``dia_hmc_proposal`` (gather-embedded, energies from the
    integrator) equals the unfused composition: the same momenta drawn in
    embedded space, the scatter-embedded ``dia_quad_leapfrog``, and the
    ELL energies of both endpoints."""
    _, _, fgs = grid_fg
    rng = np.random.default_rng(2)
    n = fgs.n_cont
    x = jnp.asarray(rng.normal(size=(9, n)), jnp.float32)
    im = jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)
    key = jax.random.PRNGKey(3)
    x1, log_acc = dia.dia_hmc_proposal(
        key, x, fgs.quad_diag, fgs.quad_dia_offsets, fgs.quad_dia_w,
        fgs.quad_h, im, 0.07, 5, pos=fgs.quad_dia_pos, inv=fgs.quad_dia_inv)
    pos = np.asarray(fgs.quad_dia_pos)
    n_emb = fgs.quad_dia_w.shape[1]
    std = np.zeros(n_emb, np.float32)
    std[pos] = np.sqrt(1.0 / np.asarray(im))
    p0 = jnp.asarray((std[None] * np.asarray(
        jax.random.normal(key, (9, n_emb))))[:, pos])
    rx, rp, lp0, lp1 = dia.dia_quad_leapfrog(
        x, p0, fgs.quad_diag, fgs.quad_dia_offsets, fgs.quad_dia_w,
        fgs.quad_h, im, 0.07, 5, pos=fgs.quad_dia_pos)
    ke = lambda p: 0.5 * jnp.sum(im[None] * p * p, -1)
    ref = jnp.minimum(0.0, (lp1 - lp0) + (ke(p0) - ke(rp)))
    np.testing.assert_allclose(np.asarray(x1), np.asarray(rx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(log_acc), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_fuzz_dia_detection_and_matvec():
    """Random banded matrices in ELL form: detection finds the offsets
    and the DIA matvec equals a dense reference (with and without a
    random monotone embedding); dense-random ELL is rejected."""
    rng = np.random.default_rng(3)
    for trial in range(8):
        n = int(rng.integers(8, 60))
        use_pos = trial % 2 == 1
        if use_pos:
            # random monotone embedding (simulates evidence gaps); the
            # band lives in embedded coordinates
            n_emb = n + int(rng.integers(1, n))
            pos = np.sort(rng.choice(n_emb, size=n, replace=False))
        else:
            n_emb, pos = n, np.arange(n)
        offs = sorted(set(int(o) for o in rng.choice(
            np.arange(-7, 8), size=rng.integers(1, 5), replace=False)
            if o != 0))
        # build a latent-space J whose EMBEDDED offsets are in `offs`
        inv = {int(e): i for i, e in enumerate(pos)}
        J = np.zeros((n, n), np.float32)
        for o in offs:
            for i in range(n):
                j = inv.get(int(pos[i]) + o)
                if j is not None and rng.uniform() < 0.8:
                    J[i, j] = rng.normal()
        D = max(1, max((np.count_nonzero(J[i]) for i in range(n)),
                       default=1))
        col = np.zeros((n, D), np.int32)
        w = np.zeros((n, D), np.float32)
        for i in range(n):
            nz = np.flatnonzero(J[i])
            col[i, : len(nz)] = nz
            w[i, : len(nz)] = J[i, nz]
        out = dia.ell_to_dia(col, w, pos=pos if use_pos else None)
        assert out is not None
        offsets, wdia, pos_out = out
        assert set(offsets) <= set(offs) or not np.any(w)
        x = jnp.asarray(rng.normal(size=(3, n)), jnp.float32)
        diag = jnp.asarray(rng.uniform(1, 2, n), jnp.float32)
        got = dia.dia_matvec(
            x, diag, offsets, jnp.asarray(wdia),
            None if pos_out is None else jnp.asarray(pos_out))
        ref = np.asarray(x) * np.asarray(diag) + np.asarray(x) @ J.T
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4,
                                   atol=1e-4)
    # a dense row pattern must be rejected (offset set too large)
    n = 32
    col = np.tile(np.arange(n, dtype=np.int32), (n, 1))
    w = np.ones((n, n), np.float32)
    assert dia.ell_to_dia(col, w) is None


def test_hmc_dia_path_recovers_oracle(grid_fg):
    """End-to-end: run_hmc with the DIA path on (default) recovers the
    dense-Gaussian oracle, and agrees with the ELL path run."""
    from lhvi_tpu.engines import gabp

    g, fgd, fgs = grid_fg
    oracle, latents = gabp.dense_gaussian_marginals(g)
    exact = np.array([oracle[id(rv)][0] for rv in latents])

    kw = dict(n_chains=32, n_warmup=200, n_samples=400, collect="moments")
    m_dia, _, _ = hmc.run_hmc(
        fgs, jax.random.PRNGKey(1),
        hmc.HMCConfig(n_leapfrog=8, init_step_size=0.2), **kw)
    errs = np.abs(np.asarray(m_dia["mean"])[: len(exact)] - exact)
    assert errs.mean() < 0.08, errs.mean()

    m_ell, _, _ = hmc.run_hmc(
        fgs, jax.random.PRNGKey(1),
        hmc.HMCConfig(n_leapfrog=8, init_step_size=0.2, dia_kernel=False),
        **kw)
    np.testing.assert_allclose(
        np.asarray(m_dia["mean"]), np.asarray(m_ell["mean"]),
        rtol=0.0, atol=0.05,
    )
