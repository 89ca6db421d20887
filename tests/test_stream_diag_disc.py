"""Streamed convergence diagnostics for DISCRETE latents + batch-means ESS:
the flagship's state is 99.7% discrete, so production
mode must ship split-R̂ evidence for it — streamed, since pod-scale runs
never materialize samples.

Ground truth: ``utils.diagnostics.split_rhat`` on the materialized
discrete VALUE traces of the very same run (same key → identical chains in
both collect modes), and Geyer ``utils.diagnostics.ess`` for the
batch-means accuracy envelope.
"""

import numpy as np
import jax
import jax.numpy as jnp

from lhvi_tpu import Domain, F, Graph, RV, compile_graph
from lhvi_tpu.engines import hmc, nuts
from lhvi_tpu.models.toy import hybrid_chain
from lhvi_tpu.models.relational import friends_smokers
from lhvi_tpu.potentials import GaussianPotential, TablePotential
from lhvi_tpu.utils.diagnostics import ess, split_rhat


def _disc_value_trace(fg, s_xd):
    """[S, C, n_disc] domain VALUES from the index samples."""
    vals = np.asarray(fg.disc_vals)  # [n_disc, V]
    return np.take_along_axis(
        np.broadcast_to(vals[None, None], s_xd.shape + (vals.shape[1],)),
        np.asarray(s_xd)[..., None], axis=-1,
    )[..., 0]


def test_hmc_streamed_rhat_disc_matches_materialized():
    g, _ = hybrid_chain()
    fg = compile_graph(g)
    cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.3)
    key = jax.random.PRNGKey(7)
    kw = dict(n_chains=8, n_warmup=100, n_samples=200)

    _, s_xd, _ = hmc.run_hmc(fg, key, cfg, collect="samples", **kw)
    _, _, diag = hmc.run_hmc(fg, key, cfg, collect="moments", **kw)

    ref = np.asarray(split_rhat(jnp.asarray(
        _disc_value_trace(fg, s_xd), jnp.float32)))
    got = np.asarray(diag["rhat_disc"])
    assert got.shape == (fg.n_disc,)
    assert np.array_equal(np.asarray(diag["disc_diag_idx"]),
                          np.arange(fg.n_disc))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    assert np.all(got < 1.3), got


def test_nuts_streamed_rhat_disc_matches_materialized():
    rg = friends_smokers(n_people=3, hybrid=True)
    rg.observe("smokes", ("p0",), 1)
    g, _ = rg.ground()
    fg = compile_graph(g)
    cfg = nuts.NUTSConfig(max_depth=4, init_step_size=0.2)
    key = jax.random.PRNGKey(3)
    kw = dict(n_chains=6, n_warmup=80, n_samples=150)

    _, s_xd, _ = nuts.run_nuts(fg, key, cfg, collect="samples", **kw)
    _, _, diag = nuts.run_nuts(fg, key, cfg, collect="moments", **kw)

    ref = np.asarray(split_rhat(jnp.asarray(
        _disc_value_trace(fg, s_xd), jnp.float32)))
    got = np.asarray(diag["rhat_disc"])
    assert got.shape == (fg.n_disc,)
    # the W=0,B=0 frozen-latent guard reports 1.0 where the materialized
    # formula degenerates — compare only where W > 0
    vtrace = _disc_value_trace(fg, s_xd)
    frozen = vtrace.std(axis=(0, 1)) == 0.0
    np.testing.assert_allclose(got[~frozen], ref[~frozen],
                               rtol=2e-4, atol=2e-4)
    assert np.all(got[frozen] == 1.0)


def test_rhat_disc_detects_stuck_chains():
    """Chains initialized in different discrete modes of a bimodal target
    with NO mixing moves between them → rhat_disc must flag it. Drive the
    accumulators directly with a synthetic stuck trace."""
    from lhvi_tpu.engines.hmc import (
        _stream_diag_disc_init, _stream_diag_disc_update,
        _stream_diag_disc_finalize,
    )

    S, C, n = 80, 8, 3
    rng = np.random.default_rng(0)
    # var 0: chains disagree persistently; var 1: well mixed; var 2: frozen
    stuck = np.where(np.arange(C) < C // 2, 1.0, 0.0)
    xs = np.zeros((S, C, n), np.float32)
    xs[:, :, 0] = stuck[None, :]
    xs[:, :, 1] = rng.integers(0, 2, (S, C))
    xs[:, :, 2] = 1.0
    sdd = _stream_diag_disc_init(C, n)
    # jitted driver — see the eager-cond executable-explosion note in
    # test_stream_diag.py::test_streamed_rhat_detects_nonconvergence
    upd = jax.jit(
        lambda sdd, t, x: _stream_diag_disc_update(sdd, t, x, S // 2))
    for t in range(S):
        sdd = upd(sdd, jnp.asarray(t), jnp.asarray(xs[t]))
    out = np.asarray(_stream_diag_disc_finalize(sdd, S)["rhat_disc"])
    assert out[0] > 2.0, out
    assert out[1] < 1.2, out
    assert out[2] == 1.0, out  # frozen: "no disagreement", not 0/0 noise


def test_disc_diag_select_stratified_deterministic():
    """Above the cap: exactly cap variables, deterministic, and covering
    every conflict-color class (the sweep's structural strata)."""
    rg = friends_smokers(n_people=12, hybrid=False)
    g, _ = rg.ground()
    fg = compile_graph(g)
    assert fg.n_disc > 24
    cap = 24
    sel1 = hmc.disc_diag_select(fg, cap)
    sel2 = hmc.disc_diag_select(fg, cap)
    assert np.array_equal(sel1, sel2)
    assert len(sel1) == cap
    assert len(np.unique(sel1)) == cap
    colors = np.asarray(fg.color_of)
    n_classes = len(np.unique(colors))
    if n_classes <= cap:
        assert len(np.unique(colors[sel1])) == n_classes
    # below the cap: identity
    assert np.array_equal(hmc.disc_diag_select(fg, fg.n_disc),
                          np.arange(fg.n_disc))


def test_streamed_rhat_disc_subsampled_matches_materialized():
    """With a cap forcing subsampling, the streamed rhat_disc equals the
    materialized split-R̂ restricted to the selected variables."""
    rg = friends_smokers(n_people=6, hybrid=False)
    g, _ = rg.ground()
    fg = compile_graph(g)
    cap = max(4, fg.n_disc // 3)
    assert cap < fg.n_disc
    cfg = hmc.HMCConfig(n_leapfrog=2)
    key = jax.random.PRNGKey(11)
    kw = dict(n_chains=6, n_warmup=20, n_samples=120)

    _, s_xd, _ = hmc.run_hmc(fg, key, cfg, collect="samples", **kw)
    _, _, diag = hmc.run_hmc(fg, key, cfg, collect="moments",
                             disc_diag_cap=cap, **kw)
    sel = np.asarray(diag["disc_diag_idx"])
    assert len(sel) == cap
    vtrace = _disc_value_trace(fg, s_xd)[:, :, sel]
    ref = np.asarray(split_rhat(jnp.asarray(vtrace, jnp.float32)))
    got = np.asarray(diag["rhat_disc"])
    frozen = vtrace.std(axis=(0, 1)) == 0.0
    np.testing.assert_allclose(got[~frozen], ref[~frozen],
                               rtol=2e-4, atol=2e-4)
    assert np.all(got[frozen] == 1.0)


def test_ess_bm_tracks_geyer_on_autocorrelated_chains():
    """Batch-means ESS vs the Geyer estimator on a strongly
    autocorrelated Gaussian target (small step → high lag-1 correlation,
    exactly where the AR(1) proxy is least defensible and bm must hold).
    Envelope: within 2× of Geyer, and both well below the naive S·C."""
    dom = Domain([-20, 20], continuous=True)
    a, b = RV(dom, name="a"), RV(dom, name="b")
    g = Graph([a, b], [F(GaussianPotential(
        [1.0, -2.0], [[1.0, 0.6], [0.6, 2.0]]), [a, b])])
    fg = compile_graph(g)
    # few, short leapfrog steps → sticky chains
    cfg = hmc.HMCConfig(n_leapfrog=2, init_step_size=0.05,
                        target_accept=0.95)
    key = jax.random.PRNGKey(5)
    kw = dict(n_chains=8, n_warmup=50, n_samples=400)

    s_xc, _, _ = hmc.run_hmc(fg, key, cfg, collect="samples", **kw)
    _, _, diag = hmc.run_hmc(fg, key, cfg, collect="moments", **kw)

    geyer = np.asarray(ess(s_xc))
    bm = np.asarray(diag["ess_bm"])
    S, C = kw["n_samples"], kw["n_chains"]
    assert np.all(bm > 0)
    assert np.all(bm <= S * C + 1e-6)
    # sticky run: both estimators must agree the draws are far from iid
    assert np.all(geyer < 0.5 * S * C)
    assert np.all(bm < 0.5 * S * C)
    ratio = bm / np.maximum(geyer, 1.0)
    assert np.all(ratio > 0.5) and np.all(ratio < 2.0), ratio


def test_ess_bm_near_iid_on_mixed_chains():
    """A well-tuned run on an easy target: ess_bm should report a healthy
    fraction of the S·C draws (sanity upper/lower bounds, not exactness)."""
    g, _ = hybrid_chain()
    fg = compile_graph(g)
    cfg = hmc.HMCConfig(n_leapfrog=8, init_step_size=0.3)
    _, _, diag = hmc.run_hmc(fg, jax.random.PRNGKey(2), cfg,
                             collect="moments", n_chains=8, n_warmup=200,
                             n_samples=400)
    bm = np.asarray(diag["ess_bm"])
    assert np.all(bm > 0.1 * 400 * 8), bm
    assert np.all(bm <= 400 * 8 + 1e-6)
