"""Exact-at-scale oracle for the ELL/DIA sparse path.

The house methodology (SURVEY.md §5, "comparison-against-exact") applied
AT deployment scale: on the 128×128 evidence grid (15,600 latents — ~4×
past the dense cap) the information matrix is sparse, so EXACT posterior
means at every dimension come from a sparse direct solve (splu), exact
variances at spot dimensions from columns of J⁻¹, and GaBP's O(E)
information form cross-checks the means independently. HMC through the
fused sparse path must agree within MC error at ALL dims — previously
the 128×128 tests asserted only finiteness and acceptance.

Wall-clock note: GaBP needs ~0.5 s for 400 segment-sum sweeps at 15.6k
vars on the CPU mesh; the splu oracle ~1 s.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from lhvi_tpu import Domain, F, Graph, RV, compile_graph
from lhvi_tpu.engines import gabp, hmc, smc
from lhvi_tpu.models.toy import gaussian_grid
from lhvi_tpu.potentials import GaussianPotential, LinearGaussianPotential


def _sparse_oracle(g):
    """(lu, mean_exact, latents): exact marginal means at all dims via a
    sparse LU of the O(E) information form; ``lu.solve(e_i)[i]`` gives
    exact variances at spot dims."""
    Jd, h, off, latents = gabp.sparse_information_form(g)
    n = len(latents)
    items = list(off.items())
    rows = np.array([k[0] for k, _ in items] + list(range(n)))
    cols = np.array([k[1] for k, _ in items] + list(range(n)))
    vals = np.array([v for _, v in items] + list(Jd))
    J = sp.csc_matrix((vals, (rows, cols)), shape=(n, n))
    lu = spla.splu(J)
    return lu, lu.solve(h), latents


@pytest.fixture(scope="module")
def grid128():
    g, _ = gaussian_grid(rows=128, cols=128, seed=1, evidence_frac=0.05)
    fg = compile_graph(g)
    assert fg.quad_sparse and fg.cont_pure_quad
    lu, mean_exact, latents = _sparse_oracle(g)
    return g, fg, lu, mean_exact


def test_gabp_sparse_information_form_exact_at_scale(grid128):
    """GaBP (segment-sum sweeps on the O(E) information form) converges
    on the walk-summable 15.6k-var grid and its means equal the sparse
    direct solve to solver precision — the at-scale exactness anchor the
    16×16 dense tests could not provide."""
    g, fg, lu, mean_exact = grid128
    bp = gabp.GaBP(g).run(400)
    assert bp.last_delta_ < 1e-6
    assert np.abs(bp.mean_ - mean_exact).max() < 1e-4


def test_ell_hmc_matches_exact_oracle_at_all_dims(grid128):
    """HMC through the fused sparse path: posterior means within MC
    error at ALL 15,600 dims, variances within MC error at 64 exact spot
    dims (columns of J⁻¹). Tolerances = observed max error (~4σ of the
    streamed-ESS-implied MC error, see docstring math) with ~60% head-
    room; a numerics break in the fused path shows up orders above."""
    g, fg, lu, mean_exact = grid128
    cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.05)
    moments, _, diag = hmc.run_hmc(
        fg, jax.random.PRNGKey(0), cfg,
        n_chains=16, n_warmup=200, n_samples=400, collect="moments",
    )
    assert float(diag["accept_rate"]) > 0.6
    m = np.asarray(moments["mean"])
    v = np.asarray(moments["var"])
    err = np.abs(m - mean_exact)
    # MC error scale: sqrt(var/ess) with streamed ess_bm ~600+ → se
    # ~0.04; max |z| over 15.6k dims ~4.2σ → ~0.16 observed
    assert err.mean() < 0.05, err.mean()
    assert err.max() < 0.25, err.max()
    ess = np.asarray(diag["ess_bm"])
    assert np.isfinite(ess).all() and ess.min() > 100

    rng = np.random.default_rng(0)
    n = len(mean_exact)
    spot = rng.choice(n, 64, replace=False)
    var_exact = np.array(
        [lu.solve(np.eye(n, 1, -int(i)).ravel())[i] for i in spot])
    rel = np.abs(v[spot] / var_exact - 1.0)
    assert rel.mean() < 0.10, rel.mean()
    assert rel.max() < 0.35, rel.max()


def _weak_grid(rows, cols, seed=0, csig=16.0, evidence_frac=0.1):
    """Weakly-coupled evidence grid: the SMC-at-scale target. Annealed
    SMC suffers weight degeneracy on STIFF high-dim targets (the strong
    grid needs budgets far beyond a CI test — measured round 5); the ELL
    exactness property under test (fused sparse moves, tempered-target
    algebra) is coupling-strength-independent, so the at-scale SMC
    anchor uses a target the anneal can actually traverse."""
    rng = np.random.default_rng(seed)
    dom = Domain([-30, 30], continuous=True)
    rvs = [[RV(dom, name=f"x{r}_{c}") for c in range(cols)]
           for r in range(rows)]
    fs = []
    for r in range(rows):
        for c in range(cols):
            mu = float(rng.normal(0.0, 1.0))
            fs.append(F(GaussianPotential([mu], [[1.0]]), [rvs[r][c]]))
            if rng.uniform() < evidence_frac:
                rvs[r][c].value = float(rng.normal(mu, 1.0))
            if c + 1 < cols:
                fs.append(F(LinearGaussianPotential(coeff=1.0, sig=csig),
                            [rvs[r][c], rvs[r][c + 1]]))
            if r + 1 < rows:
                fs.append(F(LinearGaussianPotential(coeff=1.0, sig=csig),
                            [rvs[r][c], rvs[r + 1][c]]))
    return Graph([rv for row in rvs for rv in row], fs)


def test_ell_smc_matches_exact_oracle_at_scale():
    """Adaptive SMC (production default) through the fused sparse
    rejuvenation move on a 3,645-dim ELL target: weighted posterior
    means within MC error of the sparse direct solve at all dims.
    Step size ~d^(-1/4): 0.5 collapses acceptance at this dimension
    (measured — the deadband adaptation can't recover from a start that
    rejects everything)."""
    g = _weak_grid(64, 64)
    fg = compile_graph(g, quad_max_n=1024)
    assert fg.quad_sparse
    _, mean_exact, _ = _sparse_oracle(g)
    cfg = smc.SMCConfig(n_particles=1024, n_temps=20, n_moves=2,
                        n_leapfrog=10, step_size=0.12, base_scale=1.5,
                        adaptive=True)
    xc, xd, log_w, log_z, diag = smc.run_smc(fg, jax.random.PRNGKey(4),
                                             cfg)
    lw = np.asarray(log_w)
    w = np.exp(lw - lw.max())
    w /= w.sum()
    mean = np.asarray(xc).T @ w
    err = np.abs(mean - mean_exact)
    # 1024 particles, near-full ESS → se ≈ 0.031; max over 3.6k dims
    assert err.mean() < 0.08, err.mean()
    assert err.max() < 0.30, err.max()
    assert np.isfinite(float(log_z))
