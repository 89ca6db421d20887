"""NUTS and MAP-search golden tests."""

import numpy as np
import jax

from lhvi_tpu import Domain, RV, F, Graph, compile_graph
from lhvi_tpu.engines import nuts
from lhvi_tpu.engines.map_search import HybridMaxWalkSAT, MWSConfig
from lhvi_tpu.models.toy import hybrid_chain
from lhvi_tpu.potentials import GaussianPotential
from lhvi_tpu.utils.oracle import ExactPosterior


def test_nuts_correlated_gaussian():
    mu = [1.0, -2.0]
    sig = [[1.0, 0.8], [0.8, 2.0]]
    dom = Domain([-20, 20], continuous=True)
    a, b = RV(dom, name="a"), RV(dom, name="b")
    g = Graph([a, b], [F(GaussianPotential(mu, sig), [a, b])])
    fg = compile_graph(g)
    res = nuts.sample(
        fg, jax.random.PRNGKey(0), n_chains=16, n_warmup=300, n_samples=600
    )
    assert res.diag["divergence_rate"] < 0.02
    assert res.diag["mean_depth"] >= 1.0
    assert abs(res.mean(a) - 1.0) < 0.08
    assert abs(res.mean(b) + 2.0) < 0.12
    assert abs(res.var(a) - 1.0) < 0.15
    assert abs(res.var(b) - 2.0) / 2.0 < 0.15


def test_nuts_hybrid_chain():
    g, (d, x1, x2) = hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    fg = compile_graph(g)
    res = nuts.sample(
        fg, jax.random.PRNGKey(1), n_chains=16, n_warmup=300, n_samples=800
    )
    assert abs(res.mean(x1) - exact.mean(x1)) < 0.1
    assert abs(res.mean(x2) - exact.mean(x2)) < 0.1
    assert np.abs(res.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.06


def test_mws_finds_gaussian_mode():
    dom = Domain([-20, 20], continuous=True)
    a, b = RV(dom, name="a"), RV(dom, name="b")
    g = Graph(
        [a, b],
        [F(GaussianPotential([1.5, -0.5], [[1.0, 0.4], [0.4, 1.0]]), [a, b])],
    )
    fg = compile_graph(g)
    eng = HybridMaxWalkSAT(fg, MWSConfig(n_walkers=32, n_steps=200)).run(
        jax.random.PRNGKey(0)
    )
    assert abs(eng.map(a) - 1.5) < 0.1
    assert abs(eng.map(b) + 0.5) < 0.1


def test_mws_hybrid_chain_map():
    g, (d, x1, x2) = hybrid_chain()
    exact = ExactPosterior(g, cont_grid=201)
    want = exact.map_state()
    fg = compile_graph(g)
    eng = HybridMaxWalkSAT(
        fg, MWSConfig(n_walkers=64, n_steps=400, grad_step=0.1)
    ).run(jax.random.PRNGKey(1))
    assert eng.map(d) == want[d]
    assert abs(eng.map(x1) - want[x1]) < 0.15
    assert abs(eng.map(x2) - want[x2]) < 0.15


def test_nuts_moments_and_thin_match_samples():
    """collect="moments" streams the same statistics the sample path
    yields; thin>1 runs thin transitions per emitted sample."""
    mu = [1.0, -2.0]
    sig = [[1.0, 0.8], [0.8, 2.0]]
    dom = Domain([-20, 20], continuous=True)
    a, b = RV(dom, name="a"), RV(dom, name="b")
    g = Graph([a, b], [F(GaussianPotential(mu, sig), [a, b])])
    fg = compile_graph(g)
    res = nuts.sample(
        fg, jax.random.PRNGKey(2), n_chains=32, n_warmup=300,
        n_samples=400, collect="moments", thin=2,
    )
    assert abs(res.mean(a) - 1.0) < 0.1
    assert abs(res.mean(b) + 2.0) < 0.15
    assert abs(res.var(a) - 1.0) < 0.2
    assert res.diag["divergence_rate"] < 0.02


def test_nuts_sharded_chains_public_entry():
    """run_nuts(shard=...) distributes the chain axis over the 8-device
    mesh through the public entry point."""
    from lhvi_tpu.parallel import make_mesh, chain_sharding

    mesh = make_mesh(axis_names=("dp",))
    dom = Domain([-20, 20], continuous=True)
    a, b = RV(dom, name="a"), RV(dom, name="b")
    g = Graph([a, b], [F(GaussianPotential([1.0, -2.0],
                                           [[1.0, 0.8], [0.8, 2.0]]), [a, b])])
    fg = compile_graph(g)
    sh = chain_sharding(mesh)
    moments, _, diag = nuts.run_nuts(
        fg, jax.random.PRNGKey(3), nuts.NUTSConfig(),
        n_chains=64, n_warmup=200, n_samples=300,
        collect="moments", shard=sh,
    )
    m = np.asarray(moments["mean"])
    assert abs(m[fg.meta.loc(a)[1]] - 1.0) < 0.15
    assert abs(m[fg.meta.loc(b)[1]] + 2.0) < 0.2
    assert float(diag["divergence_rate"]) < 0.05
