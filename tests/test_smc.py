"""SMC tests: Kalman LDS vs dense-Gaussian oracle (BASELINE config 4),
log-Z sanity on a conjugate case, hybrid switching model, and the sharded
particle axis on the 8-device CPU mesh (SURVEY.md §5.3)."""

import numpy as np
import jax
import jax.numpy as jnp

from lhvi_tpu import Domain, RV, F, Graph, compile_graph
from lhvi_tpu.engines import gabp, smc
from lhvi_tpu.models.lds import kalman_lds
from lhvi_tpu.models.toy import hybrid_chain
from lhvi_tpu.utils.oracle import ExactPosterior


def test_smc_gaussian_logz_and_moments():
    """Single Gaussian factor: log Z = 0 (normalized density), moments exact."""
    dom = Domain([-20, 20], continuous=True)
    x = RV(dom, name="x")
    from lhvi_tpu.potentials import GaussianPotential

    g = Graph([x], [F(GaussianPotential([2.0], [[1.5]]), [x])])
    fg = compile_graph(g)
    res = smc.sample(fg, jax.random.PRNGKey(0),
                     smc.SMCConfig(n_particles=2048, n_temps=30, n_moves=2))
    assert abs(res.mean(x) - 2.0) < 0.08
    assert abs(res.var(x) - 1.5) / 1.5 < 0.15
    assert abs(res.log_z) < 0.1, res.log_z


def test_smc_kalman_smoothing():
    g, xs, ys = kalman_lds(T=15, seed=0)
    oracle, latents = gabp.dense_gaussian_marginals(g)
    fg = compile_graph(g)
    res = smc.sample(
        fg,
        jax.random.PRNGKey(1),
        smc.SMCConfig(n_particles=4096, n_temps=50, n_moves=3, step_size=0.3),
    )
    errs = [abs(res.mean(rv) - oracle[id(rv)][0]) for rv in xs]
    vrel = [abs(res.var(rv) - oracle[id(rv)][1]) / oracle[id(rv)][1] for rv in xs]
    assert np.mean(errs) < 0.1, np.mean(errs)
    assert np.max(errs) < 0.3, np.max(errs)
    assert np.mean(vrel) < 0.3, np.mean(vrel)


def test_smc_quad_moves_match_autodiff_moves():
    """The batched fused-quadratic rejuvenation path (quad_moves=True)
    integrates the same blended tempered Hamiltonian as the per-particle
    autodiff path, so posterior moments and log-Z must agree to MC error."""
    g, xs, ys = kalman_lds(T=10, seed=1)
    oracle, _ = gabp.dense_gaussian_marginals(g)
    fg = compile_graph(g)
    assert fg.cont_pure_quad
    outs = {}
    for qm in (False, True):
        res = smc.sample(
            fg, jax.random.PRNGKey(4),
            smc.SMCConfig(n_particles=2048, n_temps=40, n_moves=2,
                          step_size=0.3, quad_moves=qm),
        )
        outs[qm] = res
        errs = [abs(res.mean(rv) - oracle[id(rv)][0]) for rv in xs]
        assert np.mean(errs) < 0.15, (qm, np.mean(errs))
    assert abs(outs[True].log_z - outs[False].log_z) < 0.5


def test_smc_hybrid_chain():
    g, (d, x1, x2) = hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    fg = compile_graph(g)
    res = smc.sample(
        fg, jax.random.PRNGKey(2),
        smc.SMCConfig(n_particles=4096, n_temps=40, n_moves=2),
    )
    assert abs(res.mean(x1) - exact.mean(x1)) < 0.1
    assert np.abs(res.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.06


def test_sharded_particle_hot_path():
    """The SMC/HMC hot path (vmapped log-prob + grad + resample gather) runs
    with the particle axis sharded over an 8-device mesh and matches the
    unsharded result exactly."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from lhvi_tpu.parallel import make_mesh, chain_sharding

    assert len(jax.devices()) == 8
    mesh = make_mesh(axis_names=("dp",))
    g, (d, x1, x2) = hybrid_chain()
    fg = compile_graph(g)
    N = 1024
    key = jax.random.PRNGKey(3)
    xc, xd = jax.vmap(fg.init_state)(jax.random.split(key, N))

    f = jax.jit(jax.vmap(fg.log_prob))
    grad_f = jax.jit(jax.vmap(jax.grad(fg.log_prob)))
    want_lp = np.asarray(f(xc, xd))
    want_g = np.asarray(grad_f(xc, xd))

    sh = chain_sharding(mesh)
    xc_s = jax.device_put(xc, sh)
    xd_s = jax.device_put(xd, sh)
    got_lp = f(xc_s, xd_s)
    got_g = grad_f(xc_s, xd_s)
    assert got_lp.sharding.is_equivalent_to(sh, 1)
    assert np.allclose(np.asarray(got_lp), want_lp, rtol=1e-5, atol=1e-5)
    assert np.allclose(np.asarray(got_g), want_g, rtol=1e-5, atol=1e-5)

    # resampling gather across the sharded axis
    lw = f(xc_s, xd_s)
    idx = smc.systematic_resample(jax.random.PRNGKey(4), lw, N)
    resampled = jnp.take(xc_s, idx, axis=0)
    assert resampled.shape == xc.shape
    assert np.isfinite(np.asarray(resampled)).all()


def test_run_smc_public_shard_matches_unsharded():
    """run_smc(shard=...) through the PUBLIC entry point: identical result
    to the unsharded run (same keys -> same anneal), particles distributed
    over the 8-device mesh."""
    from lhvi_tpu.parallel import make_mesh, chain_sharding

    mesh = make_mesh(axis_names=("dp",))
    g, (d, x1, x2) = hybrid_chain()
    fg = compile_graph(g)
    cfg = smc.SMCConfig(n_particles=512, n_temps=8, n_moves=1)
    key = jax.random.PRNGKey(5)

    xc_u, xd_u, lw_u, lz_u, _ = smc.run_smc(fg, key, cfg)
    sh = chain_sharding(mesh)
    xc_s, xd_s, lw_s, lz_s, _ = smc.run_smc(fg, key, cfg, shard=sh)

    assert np.allclose(float(lz_u), float(lz_s), rtol=1e-4, atol=1e-4)
    assert np.allclose(np.asarray(xc_u), np.asarray(xc_s),
                       rtol=1e-4, atol=1e-4)
    assert np.array_equal(np.asarray(xd_u), np.asarray(xd_s))
