"""VI engine golden tests (SURVEY.md §5.2): quadrature ELBO vs analytic
cases, and posterior marginals vs exact enumeration on the hybrid chain."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lhvi_tpu import Domain, RV, F, Graph, compile_graph
from lhvi_tpu.engines import vi
from lhvi_tpu.models.toy import hybrid_chain
from lhvi_tpu.potentials import GaussianPotential, TablePotential
from lhvi_tpu.utils.oracle import ExactPosterior


def test_elbo_analytic_gaussian():
    """K=1 ELBO on a 1D Gaussian target has closed form:
    E_q[log N(x; 0, s0²)] + H̃(q), evaluated exactly by quadrature."""
    dom = Domain([-10, 10], continuous=True)
    x = RV(dom, name="x")
    s0 = 2.0
    g = Graph([x], [F(GaussianPotential([0.0], [[s0**2]]), [x])])
    fg = compile_graph(g)

    mu, sigma = 0.7, 1.3
    params = vi.VIParams(
        log_w=jnp.zeros(1),
        mu=jnp.array([[mu]]),
        log_sigma=jnp.array([[np.log(sigma)]]),
        logits=jnp.zeros((1, 0, 1)),
    )
    got = float(vi.elbo(fg, params, n_quad=9))
    # E_q[log N(x;0,s0²)] = -.5 log(2π s0²) - (σ² + μ²)/(2 s0²)
    e_term = -0.5 * np.log(2 * np.pi * s0**2) - (sigma**2 + mu**2) / (2 * s0**2)
    # K=1 entropy bound is exact (conditional-entropy branch):
    h_term = 0.5 * np.log(2 * np.pi * np.e) + np.log(sigma)
    assert np.isclose(got, e_term + h_term, rtol=1e-4, atol=1e-4)


def test_vi_gaussian_recovers_target():
    """K=1 VI on a Gaussian target: optimum is the target itself (the
    entropy-bound gap is parameter-independent at K=1)."""
    dom = Domain([-10, 10], continuous=True)
    x = RV(dom, name="x")
    g = Graph([x], [F(GaussianPotential([1.5], [[0.49]]), [x])])
    fg = compile_graph(g)
    res = vi.infer(
        fg,
        jax.random.PRNGKey(0),
        vi.VIConfig(K=1, n_iters=1200, lr=5e-2),
    )
    assert abs(res.mean(x) - 1.5) < 0.02
    assert abs(np.sqrt(res.var(x)) - 0.7) < 0.03


def test_vi_hybrid_chain_marginals():
    g, (d, x1, x2) = hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    fg = compile_graph(g)
    res = vi.infer(
        fg,
        jax.random.PRNGKey(1),
        vi.VIConfig(K=8, n_iters=2000, lr=5e-2),
    )
    # ELBO increased and converged
    t = res.trace
    assert t[-1] > t[0]
    assert abs(res.mean(x1) - exact.mean(x1)) < 0.15
    assert abs(res.mean(x2) - exact.mean(x2)) < 0.15
    pd = res.disc_marginal(d)
    assert np.abs(pd - exact.disc_marginal(d)).max() < 0.08
    # mixture beliefs should capture most of the (correlated) variance
    assert res.var(x1) > 0.5 * exact.var(x1)


def test_vi_pure_discrete():
    """VI on a 2-var discrete chain matches enumeration."""
    dom = Domain([0, 1])
    a, b = RV(dom, name="a"), RV(dom, name="b")
    # moderate coupling: strong attractive tables make naive mean-field
    # overconfident (a known MF property, not a bug)
    g = Graph(
        [a, b],
        [
            F(TablePotential([0.2, 0.8]), [a]),
            F(TablePotential([[2.0, 1.0], [1.0, 2.0]]), [a, b]),
        ],
    )
    exact = ExactPosterior(g)
    fg = compile_graph(g)
    res = vi.infer(fg, jax.random.PRNGKey(2), vi.VIConfig(K=4, n_iters=1500))
    for rv in (a, b):
        err = np.abs(res.disc_marginal(rv) - exact.disc_marginal(rv)).max()
        assert err < 0.08, (res.disc_marginal(rv), exact.disc_marginal(rv))


def test_vi_map_is_mixture_mode_not_component_heuristic():
    """Overlapping equal components: the mode is BETWEEN the means; a
    w_k/sigma_k component pick would return one of the means."""
    x = RV(Domain([-10, 10], continuous=True), name="x")
    g = Graph([x], [F(GaussianPotential([0.0], [[1.0]]), [x])])
    fg = compile_graph(g)
    params = vi.VIParams(
        log_w=jnp.zeros(2),
        mu=jnp.array([[-0.5], [0.5]]),
        log_sigma=jnp.zeros((2, 1)),
        logits=jnp.zeros((2, 0, 1)),
    )
    res = vi.VIResult(fg, params)
    assert abs(res.map(x)) < 1e-3, res.map(x)

    # well-separated unequal components: mode = mean of the tallest one
    params2 = vi.VIParams(
        log_w=jnp.log(jnp.array([0.7, 0.3])),
        mu=jnp.array([[-3.0], [3.0]]),
        log_sigma=jnp.log(jnp.full((2, 1), 0.5)),
        logits=jnp.zeros((2, 0, 1)),
    )
    res2 = vi.VIResult(fg, params2)
    assert abs(res2.map(x) - (-3.0)) < 1e-3, res2.map(x)

    # skewed overlap: mode sits near the tall narrow component but is the
    # true density argmax, not the naive w/sigma winner
    params3 = vi.VIParams(
        log_w=jnp.log(jnp.array([0.35, 0.65])),
        mu=jnp.array([[0.0], [1.2]]),
        log_sigma=jnp.log(jnp.array([[0.4], [1.0]])),
        logits=jnp.zeros((2, 0, 1)),
    )
    res3 = vi.VIResult(fg, params3)
    grid = np.linspace(-4, 6, 200001)
    w = np.array([0.35, 0.65]); mu = np.array([0.0, 1.2]); s = np.array([0.4, 1.0])
    dens = (w[:, None] * np.exp(-0.5*((grid[None]-mu[:,None])/s[:,None])**2)
            / (s[:, None]*np.sqrt(2*np.pi))).sum(0)
    assert abs(res3.map(x) - grid[dens.argmax()]) < 2e-3
