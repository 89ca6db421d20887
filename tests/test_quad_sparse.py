"""ELL-sparse quadratic fast path: Gaussian MRFs past the
dense ``quad_max_n`` cap stay on the fused path instead of silently
falling back to the gather-based bucket evaluation.

Correctness anchor: the same graph compiled dense (small enough) and
sparse (forced via quad_max_n) must give identical energies/gradients,
and sparse-path HMC/NUTS must recover the dense-oracle marginals.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lhvi_tpu import compile_graph
from lhvi_tpu.engines import gabp, hmc, nuts
from lhvi_tpu.models.toy import gaussian_grid


@pytest.fixture(scope="module")
def grid_pair():
    g, _ = gaussian_grid(rows=16, cols=16, seed=0, evidence_frac=0.15)
    fg_dense = compile_graph(g)
    fg_sparse = compile_graph(g, quad_max_n=64)  # force the ELL path
    assert not fg_dense.quad_sparse and fg_dense.cont_pure_quad
    assert fg_sparse.quad_sparse and fg_sparse.cont_pure_quad
    return g, fg_dense, fg_sparse


def test_sparse_energy_and_grad_match_dense(grid_pair):
    _, fgd, fgs = grid_pair
    assert fgs.quad_ell_w.shape[1] <= 4  # grid: ≤4 off-diag neighbors
    xc = jnp.asarray(
        np.random.default_rng(0).normal(0, 1, (8, fgs.n_cont)), jnp.float32
    )
    np.testing.assert_allclose(
        np.asarray(fgs.quad_log_prob_batched(xc)),
        np.asarray(fgd.quad_log_prob_batched(xc)),
        rtol=1e-4, atol=1e-2,
    )
    gs = jax.grad(lambda x: fgs.quad_log_prob_batched(x).sum())(xc)
    gd = jax.grad(lambda x: fgd.quad_log_prob_batched(x).sum())(xc)
    np.testing.assert_allclose(np.asarray(gs), np.asarray(gd),
                               rtol=1e-4, atol=1e-3)
    # single-state log_prob path too
    xd = jnp.zeros((0,), jnp.int32)
    np.testing.assert_allclose(
        float(fgs.log_prob(xc[0], xd)), float(fgd.log_prob(xc[0], xd)),
        rtol=1e-4, atol=1e-2,
    )


def test_sparse_hmc_recovers_oracle_means(grid_pair):
    g, _, fgs = grid_pair
    oracle, latents = gabp.dense_gaussian_marginals(g)
    res = hmc.sample(
        fgs, jax.random.PRNGKey(0),
        n_chains=64, n_warmup=300, n_samples=500, collect="moments",
        cfg=hmc.HMCConfig(n_leapfrog=8, init_step_size=0.15),
    )
    errs = [abs(res.mean(rv) - oracle[id(rv)][0]) for rv in latents]
    vrel = [abs(res.var(rv) - oracle[id(rv)][1]) / oracle[id(rv)][1]
            for rv in latents]
    assert np.mean(errs) < 0.08, np.mean(errs)
    assert np.mean(vrel) < 0.25, np.mean(vrel)


def test_sparse_nuts_recovers_oracle_means(grid_pair):
    g, _, fgs = grid_pair
    oracle, latents = gabp.dense_gaussian_marginals(g)
    res = nuts.sample(
        fgs, jax.random.PRNGKey(1),
        n_chains=32, n_warmup=200, n_samples=400, collect="moments",
        cfg=nuts.NUTSConfig(max_depth=6),
    )
    errs = [abs(res.mean(rv) - oracle[id(rv)][0]) for rv in latents]
    assert np.mean(errs) < 0.08, np.mean(errs)


def test_128x128_grid_stays_fused():
    """The scenario verbatim: a 128×128 Gaussian grid (16,384
    vars — 4× past the dense cap) compiles to the fused ELL path, and an
    HMC step program runs finite. (A dense J here would be 1 GB.)"""
    g, _ = gaussian_grid(rows=128, cols=128, seed=1, evidence_frac=0.05)
    fg = compile_graph(g)
    assert fg.quad_sparse and fg.cont_pure_quad
    assert fg.quad_J.shape == (0, 0)  # no dense J was materialized
    moments, _, diag = hmc.run_hmc(
        fg, jax.random.PRNGKey(0),
        hmc.HMCConfig(n_leapfrog=3, init_step_size=0.05, adapt_mass=False),
        n_chains=4, n_warmup=2, n_samples=4, collect="moments",
    )
    assert np.isfinite(np.asarray(moments["mean"])).all()
    assert float(diag["accept_rate"]) > 0.3


def test_dense_rows_fall_back_to_buckets():
    """A fully coupled Gaussian past the cap must NOT build an O(n²) ELL
    table: compile un-fuses and the bucket path evaluates it."""
    from lhvi_tpu import Domain, RV, F, Graph
    from lhvi_tpu.potentials import GaussianPotential

    n = 140  # row degree 139 > the 128 ELL degree cap
    dom = Domain([-10, 10], continuous=True)
    rvs = [RV(dom, name=f"x{i}") for i in range(n)]
    rng = np.random.default_rng(0)
    A = rng.normal(0, 0.1, (n, n))
    sig = np.eye(n) + A @ A.T  # dense SPD covariance
    g = Graph(rvs, [F(GaussianPotential(np.zeros(n), sig), rvs)])
    fg = compile_graph(g, quad_max_n=64)  # force past the dense cap
    assert not fg.quad_sparse and not fg.has_quad
    assert len(fg.lp_bucket_idx) == len(fg.buckets)  # bucket path alive
    xc = jnp.asarray(rng.normal(0, 1, (n,)), jnp.float32)
    assert np.isfinite(float(fg.log_prob(xc, jnp.zeros((0,), jnp.int32))))


def test_fuzz_ell_matches_dense():
    """Randomized: sparse-forced and dense compiles of the same random
    quadratic graph (mixed Gaussian/LinearGaussian/Quadratic/XY
    potentials, random evidence, random sparse topology) agree on
    batched energies and gradients."""
    from lhvi_tpu import Domain, RV, F, Graph
    from lhvi_tpu.potentials import (
        GaussianPotential,
        LinearGaussianPotential,
        QuadraticPotential,
        XYPotential,
    )

    rng = np.random.default_rng(42)
    for trial in range(12):
        n = int(rng.integers(4, 16))
        dom = Domain([-15, 15], continuous=True)
        rvs = [RV(dom, name=f"x{i}") for i in range(n)]
        fs = [F(GaussianPotential([0.0], [[float(rng.uniform(0.5, 3.0))]]),
                [rv]) for rv in rvs]  # diagonal anchor keeps J SPD
        n_edges = int(rng.integers(1, 2 * n))
        for _ in range(n_edges):
            i, j = rng.choice(n, size=2, replace=False)
            kind = rng.integers(0, 4)
            pair = [rvs[int(i)], rvs[int(j)]]
            if kind == 0:
                fs.append(F(XYPotential(coeff=float(rng.uniform(-0.3, 0.3)),
                                        sig=1.0), pair))
            elif kind == 1:
                fs.append(F(LinearGaussianPotential(
                    coeff=float(rng.uniform(-0.8, 0.8)),
                    sig=float(rng.uniform(0.5, 2.0))), pair))
            elif kind == 2:
                A = rng.normal(0, 0.1, (2, 2))
                fs.append(F(QuadraticPotential(
                    A=-(A @ A.T) - 0.05 * np.eye(2),
                    b=rng.normal(0, 0.3, 2), c=float(rng.normal())), pair))
            else:
                mu = rng.normal(0, 1, 2)
                B = rng.normal(0, 0.3, (2, 2))
                fs.append(F(GaussianPotential(mu, B @ B.T + np.eye(2)),
                            pair))
        # random evidence on a subset
        n_obs = int(rng.integers(0, max(n // 3, 1)))
        for i in rng.choice(n, size=n_obs, replace=False):
            rvs[int(i)].value = float(rng.normal(0, 1))
        g = Graph(rvs, fs)
        fgd = compile_graph(g)
        fgs = compile_graph(g, quad_max_n=2)
        assert fgd.has_quad and not fgd.quad_sparse
        assert fgs.quad_sparse, trial
        xc = jnp.asarray(rng.normal(0, 1, (5, fgs.n_cont)), jnp.float32)
        ld = fgd.quad_log_prob_batched(xc)
        ls = fgs.quad_log_prob_batched(xc)
        np.testing.assert_allclose(np.asarray(ls), np.asarray(ld),
                                   rtol=2e-4, atol=2e-3, err_msg=str(trial))
        gd = jax.grad(lambda x: fgd.quad_log_prob_batched(x).sum())(xc)
        gs = jax.grad(lambda x: fgs.quad_log_prob_batched(x).sum())(xc)
        np.testing.assert_allclose(np.asarray(gs), np.asarray(gd),
                                   rtol=2e-4, atol=2e-3, err_msg=str(trial))


def test_ell_matvec_codegen_paths_agree():
    """ell_matvec has two codegen paths (unrolled gather·FMA for D ≤ 16,
    one-shot gather·sum above): both must equal the dense J@x on random
    ELL tables."""
    from lhvi_tpu.ops.leapfrog import ell_matvec

    rng = np.random.default_rng(3)
    for D in (1, 4, 16, 17, 24):
        n, C = 40, 6
        col = rng.integers(0, n, (n, D))
        w = rng.normal(0, 1, (n, D))
        diag = rng.uniform(1, 2, n)
        # duplicate columns within a row are summed by the dense reference
        J = np.zeros((n, n))
        np.fill_diagonal(J, diag)
        for i in range(n):
            for d in range(D):
                J[i, col[i, d]] += w[i, d]
        x = rng.normal(0, 1, (C, n))
        got = np.asarray(ell_matvec(
            jnp.asarray(x, jnp.float32), jnp.asarray(diag, jnp.float32),
            jnp.asarray(col, jnp.int32), jnp.asarray(w, jnp.float32)))
        np.testing.assert_allclose(got, x @ J.T, rtol=1e-4, atol=1e-4,
                                   err_msg=f"D={D}")


def test_smc_sparse_fused_move_matches_oracle(grid_pair):
    """Annealed SMC on an ELL-sparse pure-quad target takes the fused
    sparse rejuvenation move (explicit ∇ = h − Jx; no autodiff scatters)
    and must still recover the dense-Gaussian oracle."""
    from lhvi_tpu.engines import smc

    g, fgd, fgs = grid_pair
    oracle, latents = gabp.dense_gaussian_marginals(g)
    exact = np.array([oracle[id(rv)][0] for rv in latents])

    cfg = smc.SMCConfig(n_particles=4096, n_temps=40, n_moves=2)
    xc, xd, log_w, log_z, diag = smc.run_smc(
        fgs, jax.random.PRNGKey(4), cfg)
    w = np.exp(np.asarray(log_w) - np.max(np.asarray(log_w)))
    w /= w.sum()
    mean = np.asarray(xc).T @ w
    # same order as the compiled state: oracle latents ARE fg state order
    err = np.abs(mean[:len(exact)] - exact).max()
    assert np.isfinite(float(log_z))
    assert err < 0.25, err
    # late-anneal rejuvenation must actually move (fused path alive)
    acc = np.asarray(diag["accept"])
    assert acc[-1] > 0.1, acc


def test_smc_sparse_move_sharded_matches_unsharded(grid_pair):
    """The fused sparse rejuvenation move is pure gather·FMA — GSPMD must
    partition it natively on a sharded particle axis (no shard_map), and
    the sharded run must equal the unsharded one exactly (same keys)."""
    from lhvi_tpu.engines import smc
    from lhvi_tpu.parallel import chain_sharding, make_mesh

    _, _, fgs = grid_pair
    sh = chain_sharding(make_mesh(axis_names=("dp",)))
    cfg = smc.SMCConfig(n_particles=1024, n_temps=15, n_moves=1)
    xc0, _, lw0, lz0, _ = smc.run_smc(fgs, jax.random.PRNGKey(1), cfg)
    xc1, _, lw1, lz1, _ = smc.run_smc(fgs, jax.random.PRNGKey(1), cfg,
                                      shard=sh)
    np.testing.assert_allclose(np.asarray(xc1), np.asarray(xc0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(lz1), float(lz0), rtol=1e-5,
                               atol=1e-4)
