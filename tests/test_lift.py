"""Lifting tests (SURVEY.md §5.1/§5.2): color refinement vs brute-force
orbit reasoning on tiny graphs; lifted-vs-grounded ELBO identity; lifted VI
agreement with grounded VI on friends-smokers (BASELINE config 3)."""

import numpy as np
import jax
import jax.numpy as jnp

from lhvi_tpu import Domain, RV, F, Graph, compile_graph
from lhvi_tpu.engines import vi
from lhvi_tpu.lift import color_refine, compile_lifted, lifting_report
from lhvi_tpu.models.relational import friends_smokers
from lhvi_tpu.potentials import GaussianPotential, LinearGaussianPotential, TablePotential


def star_graph(n_leaves=5):
    """Center variable with n symmetric leaves — leaves form one orbit."""
    dom = Domain([-10, 10], continuous=True)
    center = RV(dom, name="center")
    leaves = [RV(dom, name=f"leaf{i}") for i in range(n_leaves)]
    fs = [F(GaussianPotential([0.0], [[1.0]]), [center])]
    for lf in leaves:
        fs.append(F(LinearGaussianPotential(1.0, 2.0), [center, lf]))
        fs.append(F(GaussianPotential([1.0], [[2.0]]), [lf]))
    return Graph([center] + leaves, fs), center, leaves


def test_color_refine_star():
    g, center, leaves = star_graph(5)
    rvc, fc = color_refine(g)
    leaf_colors = {rvc[id(l)] for l in leaves}
    assert len(leaf_colors) == 1
    assert rvc[id(center)] not in leaf_colors
    rep = lifting_report(g)
    assert rep["n_rv_orbits"] == 2
    assert rep["n_factor_orbits"] == 3  # center prior, couplings, leaf priors


def test_color_refine_breaks_symmetry_on_evidence():
    g, center, leaves = star_graph(5)
    leaves[0].value = 3.0
    rep = lifting_report(g)
    # observed leaf + its coupling split off
    assert rep["n_rv_orbits"] == 3
    assert rep["n_factor_orbits"] == 5


def test_asymmetric_argument_order_not_merged():
    """Factors whose args appear in different positions must not merge."""
    dom = Domain([-10, 10], continuous=True)
    a, b = RV(dom, "a"), RV(dom, "b")
    # LinearGaussian(x, y) is asymmetric: (a,b) vs (b,a) differ
    g = Graph([a, b], [
        F(LinearGaussianPotential(2.0, 1.0), [a, b]),
        F(GaussianPotential([0.0], [[1.0]]), [a]),
        F(GaussianPotential([0.0], [[1.0]]), [b]),
    ])
    rvc, _ = color_refine(g)
    assert rvc[id(a)] != rvc[id(b)]


def test_lifted_elbo_equals_grounded_elbo():
    """The core lifting invariant: ELBO(lifted IR, tied params) ==
    ELBO(grounded IR, broadcast params)."""
    g, center, leaves = star_graph(6)
    fg_l = compile_lifted(g)
    fg_g = compile_graph(g)
    assert fg_l.n_cont == 2 and fg_g.n_cont == 7

    key = jax.random.PRNGKey(0)
    cfg = vi.VIConfig(K=3)
    p_l = vi.init_params(fg_l, key, cfg)

    # broadcast lifted params to the grounded slots
    gather = np.zeros(fg_g.n_cont, np.int64)
    for rv in g.rvs:
        kind_g, i_g = fg_g.meta.loc(rv)
        kind_l, i_l = fg_l.meta.loc(rv)
        assert kind_g == kind_l == "c"
        gather[i_g] = i_l
    p_g = vi.VIParams(
        log_w=p_l.log_w,
        mu=p_l.mu[:, gather],
        log_sigma=p_l.log_sigma[:, gather],
        logits=jnp.zeros((cfg.K, 0, fg_g.max_v)),
    )
    e_l = float(vi.elbo(fg_l, p_l, n_quad=7))
    e_g = float(vi.elbo(fg_g, p_g, n_quad=7))
    assert np.isclose(e_l, e_g, rtol=1e-4, atol=1e-3), (e_l, e_g)


def test_friends_smokers_lifted_vi_vs_exact():
    """Small non-hybrid instance: lifted VI marginals vs exact enumeration.
    Weak couplings keep the posterior effectively unimodal so mean-field VI
    is a faithful approximation."""
    from lhvi_tpu.utils.oracle import ExactPosterior

    rg = friends_smokers(n_people=3, hybrid=False,
                         w_smokes_cancer=0.7, w_friends=0.4)
    g, index = rg.ground()
    exact = ExactPosterior(g)
    fg_l = compile_lifted(g)
    res = vi.infer(fg_l, jax.random.PRNGKey(0),
                   vi.VIConfig(K=2, n_iters=1500, lr=5e-2))
    for key in [("smokes", ("p0",)), ("cancer", ("p0",)),
                ("friends", ("p0", "p1"))]:
        rv = index[key]
        err = np.abs(res.disc_marginal(rv) - exact.disc_marginal(rv)).max()
        assert err < 0.1, (key, res.disc_marginal(rv), exact.disc_marginal(rv))


def test_friends_smokers_compression():
    rg = friends_smokers(n_people=8, hybrid=True)
    g, index = rg.ground()
    rep = lifting_report(g)
    # exchangeable persons -> constant orbit counts, far below ground size
    assert rep["n_rv_orbits"] <= 4
    assert rep["n_factor_orbits"] <= 5
    assert rep["n_rvs"] >= 8 * 3

    fg_l = compile_lifted(g)
    fg_g = compile_graph(g)
    # lifted IR is dramatically smaller
    n_lift = sum(int((np.asarray(b.scale) > 0).sum()) for b in fg_l.buckets)
    n_ground = sum(int((np.asarray(b.scale) > 0).sum()) for b in fg_g.buckets)
    assert n_lift * 5 < n_ground

    # lifted VI runs end-to-end on the hybrid model and improves the ELBO
    res = vi.infer(fg_l, jax.random.PRNGKey(0),
                   vi.VIConfig(K=2, n_iters=400, lr=5e-2))
    assert res.trace[-1] > res.trace[0]
    assert np.isfinite(res.trace[-1])


def test_lifted_elbo_equals_grounded_elbo_tied_slots():
    """Regression: a 3-cycle of exchangeable continuous RVs
    with XY couplings puts BOTH slots of every coupling factor on the same
    orbit slot. Quadratic fusion would fold the cross coupling J_xy onto
    the diagonal (E[x^2] = mu^2 + sigma^2 where the ground tied-parameter
    ELBO needs E[x_X]E[x_Y] = mu^2); tied factors must route to the
    unfused quadrature path."""
    from lhvi_tpu.potentials import XYPotential

    dom = Domain([-10, 10], continuous=True)
    xs = [RV(dom, name=f"x{i}") for i in range(3)]
    fs = [F(GaussianPotential([0.0], [[1.0]]), [x]) for x in xs]
    for i in range(3):
        fs.append(F(XYPotential(0.3, 1.0), [xs[i], xs[(i + 1) % 3]]))
    g = Graph(xs, fs)
    fg_l = compile_lifted(g)
    fg_g = compile_graph(g)
    assert fg_l.n_cont == 1 and fg_g.n_cont == 3

    key = jax.random.PRNGKey(1)
    cfg = vi.VIConfig(K=2)
    p_l = vi.init_params(fg_l, key, cfg)
    gather = np.zeros(fg_g.n_cont, np.int64)  # every ground var -> orbit 0
    p_g = vi.VIParams(
        log_w=p_l.log_w,
        mu=p_l.mu[:, gather],
        log_sigma=p_l.log_sigma[:, gather],
        logits=jnp.zeros((cfg.K, 0, fg_g.max_v)),
    )
    e_l = float(vi.elbo(fg_l, p_l, n_quad=9))
    e_g = float(vi.elbo(fg_g, p_g, n_quad=9))
    assert np.isclose(e_l, e_g, rtol=1e-4, atol=1e-3), (e_l, e_g)
