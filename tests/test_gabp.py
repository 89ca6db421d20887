"""GaBP tests: exact on trees; means exact on the walk-summable 10×10 grid
with discrete-… er, Gaussian evidence (BASELINE config 2; SURVEY.md §5.2)."""

import numpy as np
import jax

from lhvi_tpu import Domain, RV, F, Graph, compile_graph
from lhvi_tpu.engines import gabp, hmc, vi
from lhvi_tpu.models.toy import gaussian_grid
from lhvi_tpu.potentials import GaussianPotential, LinearGaussianPotential


def test_gabp_tree_exact():
    """Chain (tree): GaBP means AND variances equal the dense solve."""
    dom = Domain([-20, 20], continuous=True)
    xs = [RV(dom, name=f"x{i}") for i in range(5)]
    fs = [F(GaussianPotential([float(i)], [[1.0 + 0.1 * i]]), [xs[i]]) for i in range(5)]
    fs += [
        F(LinearGaussianPotential(coeff=0.8, sig=2.0), [xs[i], xs[i + 1]])
        for i in range(4)
    ]
    g = Graph(xs, fs)
    oracle, _ = gabp.dense_gaussian_marginals(g)
    eng = gabp.GaBP(g).run(iters=30)
    for rv in xs:
        m, v = oracle[id(rv)]
        assert np.isclose(eng.mean(rv), m, atol=1e-4), rv
        assert np.isclose(eng.var(rv), v, rtol=1e-4), rv


def test_gabp_grid_means_match_dense():
    g, rvs = gaussian_grid(rows=6, cols=6, seed=1, evidence_frac=0.25)
    oracle, latents = gabp.dense_gaussian_marginals(g)
    eng = gabp.GaBP(g).run(iters=120)
    for rv in latents:
        m, _ = oracle[id(rv)]
        assert np.isclose(eng.mean(rv), m, atol=1e-3), (rv, eng.mean(rv), m)


def test_hmc_matches_gabp_on_grid():
    """Cross-engine agreement on the Gaussian grid (BASELINE config 2)."""
    g, rvs = gaussian_grid(rows=5, cols=5, seed=2, evidence_frac=0.2)
    oracle, latents = gabp.dense_gaussian_marginals(g)
    fg = compile_graph(g)
    res = hmc.sample(
        fg, jax.random.PRNGKey(0), n_chains=32, n_warmup=400, n_samples=1000
    )
    errs_m, errs_v = [], []
    for rv in latents:
        m, v = oracle[id(rv)]
        errs_m.append(abs(res.mean(rv) - m))
        errs_v.append(abs(res.var(rv) - v) / v)
    assert np.mean(errs_m) < 0.1, np.mean(errs_m)
    assert np.max(errs_m) < 0.35, np.max(errs_m)
    assert np.mean(errs_v) < 0.2, np.mean(errs_v)


def test_vi_matches_gabp_means_on_grid():
    g, rvs = gaussian_grid(rows=5, cols=5, seed=3, evidence_frac=0.2)
    oracle, latents = gabp.dense_gaussian_marginals(g)
    fg = compile_graph(g)
    res = vi.infer(fg, jax.random.PRNGKey(1), vi.VIConfig(K=2, n_iters=2500, lr=5e-2))
    errs = [abs(res.mean(rv) - oracle[id(rv)][0]) for rv in latents]
    assert np.mean(errs) < 0.1, np.mean(errs)
    assert np.max(errs) < 0.3, np.max(errs)


def test_gabp_scales_to_100x100_grid():
    """Sparse edge-list construction from factor adjacency: 10k-variable
    grid builds + runs in seconds of host time (the dense double loop was
    O(n^2))."""
    import time
    from lhvi_tpu.models.toy import gaussian_grid

    g, _ = gaussian_grid(rows=100, cols=100, seed=0, evidence_frac=0.1)
    t0 = time.perf_counter()
    eng = gabp.GaBP(g)
    build_s = time.perf_counter() - t0
    assert build_s < 5.0, f"GaBP construction took {build_s:.1f}s"
    eng.run(iters=60)
    assert np.isfinite(eng.mean_).all()
    # spot-check one latent against the dense oracle on a smaller instance
    g2, _ = gaussian_grid(rows=8, cols=8, seed=1, evidence_frac=0.1)
    oracle, latents = gabp.dense_gaussian_marginals(g2)
    eng2 = gabp.GaBP(g2).run(iters=80)
    errs = [abs(eng2.mean(rv) - oracle[id(rv)][0]) for rv in latents]
    assert max(errs) < 1e-3, max(errs)
