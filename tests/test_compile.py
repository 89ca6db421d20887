"""Compiler tests: IR log_prob vs factor-by-factor oracle on hybrid models."""

import numpy as np
import jax
import jax.numpy as jnp

from lhvi_tpu import Domain, RV, F, Graph, compile_graph
from lhvi_tpu.potentials import (
    GaussianPotential,
    LinearGaussianPotential,
    TablePotential,
    MLNPotential,
)


def hybrid_chain():
    """3-variable hybrid Gaussian–discrete chain (BASELINE config 1):
    d -- x1 -- x2 with d in {0,1}, x continuous."""
    dom_d = Domain([0, 1])
    dom_c = Domain([-10, 10], continuous=True)
    d = RV(dom_d, name="d")
    x1 = RV(dom_c, name="x1")
    x2 = RV(dom_c, name="x2")
    # p(d): prior
    f0 = F(TablePotential([0.3, 0.7]), [d])
    # coupling d->x1: mixture mean switch via MLN-style formula
    f1 = F(
        MLNPotential(
            lambda args: -((args[1] - (2.0 * args[0] - 1.0)) ** 2),
            w=0.5,
            formula_name="switch_mean",
        ),
        [d, x1],
    )
    f2 = F(LinearGaussianPotential(coeff=1.0, sig=1.0), [x1, x2])
    f3 = F(GaussianPotential([0.0], [[4.0]]), [x2])
    g = Graph([d, x1, x2], [f0, f1, f2, f3])
    return g, (d, x1, x2)


def manual_log_prob(g, assign):
    """Independent recomputation of the joint at one state."""
    total = 0.0
    for f in g.factors:
        pattern = tuple(rv.domain.continuous for rv in f.nb)
        args = []
        for rv in f.nb:
            v = assign.get(id(rv), rv.value)
            if rv.domain.continuous:
                args.append(float(v))
            else:
                args.append((rv.domain.value_index(v), float(v)))
        total += f.potential.log_value(args, pattern)
    return total


def test_log_prob_matches_manual():
    g, (d, x1, x2) = hybrid_chain()
    fg = compile_graph(g)
    assert fg.n_cont == 2 and fg.n_disc == 1

    for dv, a, b in [(0, 0.5, -0.3), (1, -1.2, 2.0)]:
        (kd, id_d) = fg.meta.loc(d)
        (kc1, i1) = fg.meta.loc(x1)
        (kc2, i2) = fg.meta.loc(x2)
        xc = np.zeros(2, np.float32)
        xc[i1], xc[i2] = a, b
        xd = np.array([d.domain.value_index(dv)], np.int32)
        got = float(fg.log_prob(jnp.asarray(xc), jnp.asarray(xd)))
        want = manual_log_prob(g, {id(d): dv, id(x1): a, id(x2): b})
        assert np.isclose(got, want, rtol=1e-4, atol=1e-4), (dv, a, b)


def test_log_prob_with_evidence():
    g, (d, x1, x2) = hybrid_chain()
    x2.value = 1.5  # observe x2
    fg = compile_graph(g)
    assert fg.n_cont == 1 and fg.n_disc == 1
    (_, i1) = fg.meta.loc(x1)
    xc = jnp.array([0.7], jnp.float32)
    xd = jnp.array([1], jnp.int32)
    got = float(fg.log_prob(xc, xd))
    want = manual_log_prob(g, {id(d): 1, id(x1): 0.7})
    assert np.isclose(got, want, rtol=1e-4, atol=1e-4)
    x2.value = None


def test_log_prob_jit_grad_vmap():
    g, (d, x1, x2) = hybrid_chain()
    fg = compile_graph(g)

    f = jax.jit(lambda xc, xd: fg.log_prob(xc, xd))
    gradf = jax.jit(jax.grad(lambda xc, xd: fg.log_prob(xc, xd)))
    xc = jnp.array([0.1, -0.2])
    xd = jnp.array([0], jnp.int32)
    v = float(f(xc, xd))
    gv = gradf(xc, xd)
    assert np.isfinite(v) and gv.shape == (2,)
    # numeric grad check
    eps = 1e-3
    for i in range(2):
        e = jnp.zeros(2).at[i].set(eps)
        num = (float(f(xc + e, xd)) - float(f(xc - e, xd))) / (2 * eps)
        assert np.isclose(float(gv[i]), num, rtol=2e-2, atol=2e-2)

    # vmap over a chain axis
    xcs = jnp.stack([xc, xc + 1.0])
    xds = jnp.stack([xd, xd])
    out = jax.vmap(fg.log_prob)(xcs, xds)
    assert out.shape == (2,)


def test_disc_logits_match_conditionals():
    g, (d, x1, x2) = hybrid_chain()
    fg = compile_graph(g)
    xc = jnp.array([0.4, -1.1])
    logits = np.asarray(fg.disc_logits(xc, jnp.array([0], jnp.int32)))
    # conditional logit difference must equal joint log-prob difference
    lp0 = float(fg.log_prob(xc, jnp.array([0], jnp.int32)))
    lp1 = float(fg.log_prob(xc, jnp.array([1], jnp.int32)))
    assert np.isclose(logits[0, 1] - logits[0, 0], lp1 - lp0, rtol=1e-4, atol=1e-4)


def test_padding_invariance():
    g, _ = hybrid_chain()
    a = compile_graph(g, pad_to=1)
    b = compile_graph(g, pad_to=32)
    xc = jnp.array([0.3, 0.9])
    xd = jnp.array([1], jnp.int32)
    assert np.isclose(float(a.log_prob(xc, xd)), float(b.log_prob(xc, xd)), rtol=1e-5)


def test_chromatic_coloring_valid():
    g, _ = hybrid_chain()
    fg = compile_graph(g)
    # every discrete latent has a valid color id
    co = np.asarray(fg.color_of)
    assert co.shape == (fg.n_disc,)
    assert (co >= 0).all() and (co < fg.n_colors).all()


def test_disc_logits_identity_on_relational_model():
    """Gather-plan regression net: for every discrete latent v and value c,
    logits[v,c] - logits[v,cur] must equal the joint log-prob difference of
    flipping v to c — across a model with multiple buckets, slot positions,
    and incidence degrees (friends-smokers with evidence)."""
    from lhvi_tpu.models.relational import friends_smokers

    rg = friends_smokers(n_people=4, hybrid=True)
    rg.observe("smokes", ("p0",), 1)
    g2, _ = rg.ground()
    fg = compile_graph(g2)
    assert len(fg.gibbs.degrees) >= 2  # several degree groups exercised

    key = jax.random.PRNGKey(0)
    xc, xd = fg.init_state(key)
    logits = np.asarray(fg.disc_logits(xc, xd))
    base_lp = float(fg.log_prob(xc, xd))
    xd_np = np.asarray(xd)
    sizes = np.asarray(fg.disc_sizes)
    rng = np.random.default_rng(0)
    for v in rng.choice(fg.n_disc, size=12, replace=False):
        cur = int(xd_np[v])
        for c in range(int(sizes[v])):
            xd2 = jnp.asarray(xd_np).at[v].set(c)
            want = float(fg.log_prob(xc, xd2)) - base_lp
            got = logits[v, c] - logits[v, cur]
            assert np.isclose(got, want, rtol=1e-3, atol=1e-3), (v, c, got, want)


def test_disc_logits_repeated_discrete_argument():
    """A grounded factor referencing the same discrete latent in TWO slots
    must yield full conditionals built from log phi(v, v)
    counted once — not log phi(v, cur) + log phi(cur, v). Checked via the
    conditional-vs-joint identity, which log_prob (correct for repeated
    slots by construction) anchors."""
    rng = np.random.RandomState(0)
    dom = Domain([0, 1, 2])
    d = RV(dom, name="d")
    e = RV(dom, name="e")
    g = Graph(
        [d, e],
        [
            F(TablePotential(np.exp(rng.randn(3, 3))), [d, d]),  # repeated
            F(TablePotential(np.exp(rng.randn(3, 3))), [d, e]),
            F(TablePotential([0.2, 0.5, 0.3]), [e]),
        ],
    )
    fg = compile_graph(g)
    xc = jnp.zeros(0)
    loc = {0: fg.meta.loc(d)[1], 1: fg.meta.loc(e)[1]}
    for cur in ([0, 1], [2, 0], [1, 2]):
        xd = np.zeros(2, np.int32)
        xd[loc[0]], xd[loc[1]] = cur
        logits = np.asarray(fg.disc_logits(xc, jnp.asarray(xd)))
        base = float(fg.log_prob(xc, jnp.asarray(xd)))
        for v_i in range(2):
            for c in range(3):
                xd2 = xd.copy()
                xd2[v_i] = c
                lp = float(fg.log_prob(xc, jnp.asarray(xd2)))
                assert np.isclose(
                    logits[v_i, c] - logits[v_i, xd[v_i]], lp - base,
                    rtol=1e-4, atol=1e-4,
                ), (cur, v_i, c)


def test_log_prob_batched_matches_vmap():
    """Batched log-prob family == vmap(log_prob); the continuous-part
    variant differs by an xc-constant per state (grad-identical)."""
    from lhvi_tpu.models.relational import friends_smokers

    rg = friends_smokers(n_people=4, hybrid=True)
    rg.observe("smokes", ("p0",), 1)
    g, _ = rg.ground()
    fg = compile_graph(g)
    key = jax.random.PRNGKey(0)
    C = 5
    xc, xd = fg.init_state_batched(key, C)

    ref = jax.vmap(fg.log_prob)(xc, xd)
    got = fg.log_prob_batched(xc, xd)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)

    # continuous part: full − cont is constant in xc (per state)
    cont = fg.log_prob_cont_batched(xc, xd)
    delta1 = np.asarray(ref - cont)
    xc2 = xc + 0.37
    delta2 = np.asarray(
        fg.log_prob_batched(xc2, xd) - fg.log_prob_cont_batched(xc2, xd)
    )
    np.testing.assert_allclose(delta1, delta2, rtol=1e-4, atol=1e-4)

    # gradients identical
    g1 = jax.grad(lambda x: jnp.sum(fg.log_prob_batched(x, xd)))(xc)
    g2 = jax.grad(lambda x: jnp.sum(fg.log_prob_cont_batched(x, xd)))(xc)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                               rtol=1e-4, atol=1e-5)


def test_log_prob_batched_no_disc_and_no_cont():
    """Degenerate axes: all-continuous and all-discrete models."""
    from lhvi_tpu.models.toy import gaussian_grid

    g, _ = gaussian_grid(rows=3, cols=3, seed=0, evidence_frac=0.2)
    fg = compile_graph(g)
    xc, xd = fg.init_state_batched(jax.random.PRNGKey(1), 4)
    np.testing.assert_allclose(
        np.asarray(fg.log_prob_batched(xc, xd)),
        np.asarray(jax.vmap(fg.log_prob)(xc, xd)),
        rtol=1e-5, atol=1e-5,
    )

    rng = np.random.RandomState(0)
    dom = Domain([0, 1, 2])
    d, e = RV(dom, name="d"), RV(dom, name="e")
    gd = Graph(
        [d, e],
        [F(TablePotential(np.exp(rng.randn(3, 3))), [d, e])],
    )
    fgd = compile_graph(gd)
    xc, xd = fgd.init_state_batched(jax.random.PRNGKey(2), 4)
    np.testing.assert_allclose(
        np.asarray(fgd.log_prob_batched(xc, xd)),
        np.asarray(jax.vmap(fgd.log_prob)(xc, xd)),
        rtol=1e-5, atol=1e-5,
    )
