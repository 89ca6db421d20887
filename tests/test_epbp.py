"""EPBP tests: particle-BP marginals vs exact enumeration / GaBP."""

import numpy as np
import jax

from lhvi_tpu import Domain, RV, F, Graph, compile_graph
from lhvi_tpu.engines.epbp import EPBP, EPBPConfig
from lhvi_tpu.models.toy import hybrid_chain
from lhvi_tpu.potentials import GaussianPotential, LinearGaussianPotential
from lhvi_tpu.utils.oracle import ExactPosterior


def test_epbp_hybrid_chain():
    g, (d, x1, x2) = hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    fg = compile_graph(g)
    eng = EPBP(fg, EPBPConfig(n_particles=128, n_iters=40)).run(
        jax.random.PRNGKey(1)
    )
    # EPBP is a stochastic message-passing approximation: tolerances sized
    # to its single-particle-set MC error at P=128
    assert np.abs(eng.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.08
    assert abs(eng.mean(x1) - exact.mean(x1)) < 0.22
    assert abs(eng.mean(x2) - exact.mean(x2)) < 0.22
    assert abs(eng.var(x2) - exact.var(x2)) / exact.var(x2) < 0.4


def test_epbp_gaussian_chain_vs_gabp():
    from lhvi_tpu.engines import gabp

    dom = Domain([-10, 10], continuous=True)
    xs = [RV(dom, name=f"x{i}") for i in range(4)]
    fs = [F(GaussianPotential([1.0], [[1.0]]), [xs[0]])]
    for i in range(3):
        fs.append(F(LinearGaussianPotential(0.7, 1.2), [xs[i], xs[i + 1]]))
    g = Graph(xs, fs)
    oracle, _ = gabp.dense_gaussian_marginals(g)
    fg = compile_graph(g)
    eng = EPBP(fg, EPBPConfig(n_particles=128, n_iters=50)).run(
        jax.random.PRNGKey(0)
    )
    for rv in xs:
        m, v = oracle[id(rv)]
        assert abs(eng.mean(rv) - m) < 0.25, (rv, eng.mean(rv), m)
        assert abs(eng.var(rv) - v) / v < 0.4, (rv, eng.var(rv), v)


def test_epbp_large_discrete_domain_small_particle_count():
    """Discrete grid axes use the true domain size, decoupled from P: a
    12-value domain runs exactly with only 8 particles (the old support
    tables required n_particles >= max_v)."""
    from lhvi_tpu.potentials import MLNPotential, TablePotential

    vals = list(range(12))
    d = RV(Domain(vals), name="d")
    x = RV(Domain([-8.0, 20.0], continuous=True), name="x")
    prior = np.linspace(1.0, 2.0, 12)
    g = Graph(
        [d, x],
        [
            F(TablePotential(prior / prior.sum()), [d]),
            # unary anchor keeps x's belief (and so the importance
            # proposal) narrow — isolates the mechanism under test from
            # small-P proposal-mismatch MC error
            F(GaussianPotential([4.0], [[1.0]]), [x]),
            F(
                MLNPotential(
                    lambda a: -0.5 * (a[1] - a[0]) ** 2,
                    w=1.0,
                    formula_name="link",
                ),
                [d, x],
            ),
        ],
    )
    exact = ExactPosterior(g, cont_grid=201)
    fg = compile_graph(g)
    assert fg.max_v == 12
    # P=64 > domain: mixed 64/12 grid axes, tight accuracy
    eng = EPBP(fg, EPBPConfig(n_particles=64, n_iters=40)).run(
        jax.random.PRNGKey(3)
    )
    assert np.abs(eng.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.05
    assert abs(eng.mean(x) - exact.mean(x)) < 0.3
    # P=8 < domain size: impossible before the decoupling; tolerance sized
    # to the genuine 8-particle importance-sampling error (mechanism is
    # exact — see the P=64 run above)
    eng8 = EPBP(fg, EPBPConfig(n_particles=8, n_iters=40)).run(
        jax.random.PRNGKey(3)
    )
    assert np.abs(eng8.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.25
    assert abs(eng8.mean(x) - exact.mean(x)) < 1.0


def test_epbp_arity3_hybrid_factor():
    """Ternary factors (2 discrete + 1 continuous): the O(P^3) grid path."""
    from lhvi_tpu.potentials import MLNPotential, TablePotential

    b = Domain([0, 1])
    z1, z2 = RV(b, name="z1"), RV(b, name="z2")
    x = RV(Domain([-6, 6], continuous=True), name="x")
    g = Graph(
        [z1, z2, x],
        [
            F(TablePotential([0.7, 0.3]), [z1]),
            F(TablePotential([[2.0, 1.0], [1.0, 2.0]]), [z1, z2]),
            F(
                MLNPotential(
                    lambda a: -a[0] * a[1] * (a[2] - 2.0) ** 2
                    - (1.0 - a[0] * a[1]) * (a[2] + 1.0) ** 2 * 0.5,
                    w=0.8,
                    formula_name="gate_mean",
                ),
                [z1, z2, x],
            ),
        ],
    )
    exact = ExactPosterior(g, cont_grid=161)
    fg = compile_graph(g)
    eng = EPBP(fg, EPBPConfig(n_particles=64, n_iters=40)).run(
        jax.random.PRNGKey(2)
    )
    assert np.abs(eng.disc_marginal(z1) - exact.disc_marginal(z1)).max() < 0.08
    assert np.abs(eng.disc_marginal(z2) - exact.disc_marginal(z2)).max() < 0.08
    assert abs(eng.mean(x) - exact.mean(x)) < 0.3
