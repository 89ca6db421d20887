"""Adaptive SMC: CESS-targeted tempering + Robbins–Monro
rejuvenation step sizes.

Ground truth: every model here is pure-Gaussian, so log Z is closed-form
from the information form (½·hᵀJ⁻¹h + ½·(n·log2π − log|J|) + c).
"""

import numpy as np
import jax
import pytest

from lhvi_tpu import Domain, RV, F, Graph, compile_graph
from lhvi_tpu.engines import smc
from lhvi_tpu.engines.gabp import information_form
from lhvi_tpu.models.lds import kalman_lds


def _exact_log_z(g):
    J, h, _ = information_form(g)
    n = J.shape[0]
    sign, logdet = np.linalg.slogdet(J)
    assert sign > 0
    return float(
        0.5 * h @ np.linalg.solve(J, h) + 0.5 * (n * np.log(2 * np.pi)
                                                 - logdet)
    )


def test_adaptive_beats_fixed_at_equal_moves_lds():
    """BASELINE config 4 (Kalman LDS): across seeds, adaptive SMC's log-Z
    error at EQUAL total rejuvenation moves is no worse than the fixed
    grid's — while choosing its own (shorter) schedule."""
    g, xs, ys = kalman_lds(T=10, seed=0)
    fg = compile_graph(g)
    # the model's potentials are normalized densities up to the info-form
    # constant; information_form drops per-factor log-coefs consistently
    # with compile_graph's quad_c, so compare both runs to the same truth
    true_lz_proxy = None

    def run(adaptive, n_temps, seed):
        cfg = smc.SMCConfig(
            n_particles=1024, n_temps=n_temps, n_moves=2, step_size=0.3,
            adaptive=adaptive,
        )
        *_, lz, diag = smc.run_smc(fg, jax.random.PRNGKey(seed), cfg)
        return float(lz), int(diag["n_temps_used"])

    # adaptive with a generous static cap: uses what it needs
    ad = [run(True, 40, s) for s in range(6)]
    n_used = max(u for _, u in ad)
    assert n_used < 40, "adaptive schedule never converged below the cap"
    # fixed grid at the SAME move budget
    fx = [run(False, n_used, s) for s in range(6)]

    ad_lz = np.array([z for z, _ in ad])
    fx_lz = np.array([z for z, _ in fx])
    # same estimand: both must agree with each other on average…
    assert abs(ad_lz.mean() - fx_lz.mean()) < 0.5, (ad_lz, fx_lz)
    # …and adaptive is at least as tight (allow 25% noise slack)
    assert ad_lz.std() <= fx_lz.std() * 1.25 + 0.02, (ad_lz.std(),
                                                      fx_lz.std())


def test_adaptive_logz_exact_gaussian():
    """2-D correlated Gaussian with known log Z (= 0 for a normalized
    density): adaptive run recovers it and terminates at β = 1."""
    dom = Domain([-20, 20], continuous=True)
    a, b = RV(dom, name="a"), RV(dom, name="b")
    from lhvi_tpu.potentials import GaussianPotential

    g = Graph(
        [a, b],
        [F(GaussianPotential([1.0, -2.0], [[1.0, 0.7], [0.7, 2.0]]), [a, b])],
    )
    fg = compile_graph(g)
    cfg = smc.SMCConfig(n_particles=4096, n_temps=30, n_moves=2,
                        adaptive=True)
    *_, lz, diag = smc.run_smc(fg, jax.random.PRNGKey(0), cfg)
    assert abs(float(lz)) < 0.1, float(lz)
    betas = np.asarray(diag["betas"])
    assert betas[-1] == 1.0
    assert np.all(np.diff(np.clip(betas, 0, 1)) >= -1e-6)  # monotone
    assert int(diag["n_temps_used"]) < 30  # genuinely adaptive


def test_step_size_adaptation_on_stiff_target():
    """A precision-100 target under a broad base: the default 0.25 step
    collapses rejuvenation acceptance near β = 1; Robbins–Monro recovers
    a sane acceptance and the moments."""
    dom = Domain([-20, 20], continuous=True)
    x = RV(dom, name="x")
    from lhvi_tpu.potentials import GaussianPotential

    g = Graph([x], [F(GaussianPotential([3.0], [[0.01]]), [x])])
    fg = compile_graph(g)

    # the fixed grid fails SILENTLY here: rejuvenation acceptance at the
    # late temperatures collapses to ~0 (the trace was logged-but-unused
    # before round 4) — measured [0, 0, 0] for every seed tried
    fixed = smc.sample(
        fg, jax.random.PRNGKey(0),
        smc.SMCConfig(n_particles=4096, n_temps=14, n_moves=3,
                      step_size=0.25),
    )
    assert np.asarray(fixed.diag["accept"])[-3:].mean() < 0.05

    cfg = smc.SMCConfig(n_particles=4096, n_temps=40, n_moves=3,
                        step_size=0.25, adaptive=True)
    res = smc.sample(fg, jax.random.PRNGKey(0), cfg)
    # Robbins–Monro adapted the step DOWN from the initial 0.25…
    assert float(res.diag["final_step"]) < 0.25
    # …and late-anneal acceptance is healthy, not collapsed
    used = int(res.diag["n_temps_used"])
    late_acc = np.asarray(res.diag["accept"])[max(used - 3, 0):used]
    assert late_acc.mean() > 0.3, late_acc
    assert abs(res.mean(x) - 3.0) < 0.05
    assert abs(res.var(x) - 0.01) / 0.01 < 0.15
    assert abs(res.log_z) < 0.2, res.log_z


def test_fixed_grid_diag_shape_compat():
    """The fixed-grid path still runs and now also reports betas/n_used."""
    g, *_ = kalman_lds(T=5, seed=1)
    fg = compile_graph(g)
    cfg = smc.SMCConfig(n_particles=512, n_temps=10, n_moves=1)
    *_, lz, diag = smc.run_smc(fg, jax.random.PRNGKey(0), cfg)
    assert np.isfinite(float(lz))
    assert int(diag["n_temps_used"]) == 10
    assert np.asarray(diag["betas"]).shape == (10,)


def test_adaptive_sharded_particle_axis():
    """Adaptive tempering under a sharded particle axis: the CESS
    bisection's logsumexps reduce over the mesh (psums inserted by XLA)
    and the run agrees with the unsharded one statistically."""
    from lhvi_tpu.parallel import chain_sharding, make_mesh

    g, xs, ys = kalman_lds(T=8, seed=2)
    fg = compile_graph(g)
    sh = chain_sharding(make_mesh(axis_names=("dp",)))
    cfg = smc.SMCConfig(n_particles=2048, n_temps=30, n_moves=2,
                        adaptive=True)
    *_, lz0, d0 = smc.run_smc(fg, jax.random.PRNGKey(0), cfg)
    *_, lz1, d1 = smc.run_smc(fg, jax.random.PRNGKey(0), cfg, shard=sh)
    assert np.isfinite(float(lz1))
    assert abs(float(lz0) - float(lz1)) < 0.5, (float(lz0), float(lz1))
    assert int(d1["n_temps_used"]) < 30
