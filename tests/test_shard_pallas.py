"""Kernels under a sharded chain axis (shard_map dispatch).

The CI mesh is CPU (conftest), where the engines take the XLA leapfrog —
those runs validate the cfg.shard plumbing and the shard_map helper. The
Triton quad leapfrog itself runs here in interpret mode under
``shard_map_chains`` and must equal the unsharded kernel bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np

from lhvi_tpu import compile_graph
from lhvi_tpu.engines import hmc, nuts
from lhvi_tpu.models.toy import gaussian_grid
from lhvi_tpu.parallel import chain_sharding, make_mesh
from lhvi_tpu.parallel.mesh import chain_axes, shard_map_chains


def _grid_fg():
    g, _ = gaussian_grid(rows=4, cols=4, seed=0, evidence_frac=0.2)
    return compile_graph(g)


def test_shard_map_chains_helper():
    mesh = make_mesh(axis_names=("dp",))
    sh = chain_sharding(mesh)
    assert chain_axes(sh) == ("dp",)
    assert chain_axes(None) == ()

    f = shard_map_chains(lambda x, y: x + y[None, :], sh, n_sharded_args=1)
    x = np.arange(32.0).reshape(16, 2)
    y = np.ones(2)
    out = jax.jit(lambda a, b: f(a, b))(x, y)
    np.testing.assert_allclose(np.asarray(out), x + 1.0)

    # uneven chain counts fall back to the direct call (and honor an
    # explicit fallback fn, needed when the body uses axis_index)
    x10 = np.arange(20.0).reshape(10, 2)
    out = jax.jit(lambda a, b: f(a, b))(x10, y)
    np.testing.assert_allclose(np.asarray(out), x10 + 1.0)
    g = shard_map_chains(lambda x, y: x + y[None, :], sh, n_sharded_args=1,
                         fallback=lambda x, y: x - y[None, :])
    out = jax.jit(lambda a, b: g(a, b))(x10, y)
    np.testing.assert_allclose(np.asarray(out), x10 - 1.0)


def test_run_nuts_sharded_keeps_pallas_flag():
    """run_nuts(shard=...) on a pure-quadratic grid: the lockstep XLA tree
    partitions over the chain axis and returns finite moments."""
    fg = _grid_fg()
    mesh = make_mesh(axis_names=("dp",))
    sh = chain_sharding(mesh)
    m, _, diag = nuts.run_nuts(
        fg, jax.random.PRNGKey(0), nuts.NUTSConfig(max_depth=4),
        n_chains=64, n_warmup=50, n_samples=100, collect="moments", shard=sh,
    )
    assert np.isfinite(np.asarray(m["mean"])).all()


def test_run_hmc_sharded_quad_path():
    """Sharded run (cfg.shard stamped) recovers the exact posterior.

    Bitwise equality with the unsharded run is NOT expected on a real
    multi-device mesh: cross-device reduction order perturbs the adapted
    step size at the last ulp and HMC trajectories are chaotic in it.
    Statistical agreement with the dense oracle is the invariant.
    """
    from lhvi_tpu.engines.gabp import dense_gaussian_marginals

    g, _ = gaussian_grid(rows=4, cols=4, seed=0, evidence_frac=0.2)
    fg = compile_graph(g)
    oracle, latents = dense_gaussian_marginals(g)
    mesh = make_mesh(axis_names=("dp",))
    sh = chain_sharding(mesh)
    res = hmc.sample(
        fg, jax.random.PRNGKey(0),
        n_chains=256, n_warmup=200, n_samples=400, collect="moments",
        shard=sh,
    )
    errs = [abs(res.mean(rv) - oracle[id(rv)][0]) for rv in latents]
    assert np.mean(errs) < 0.08, np.mean(errs)


def test_sharded_triton_leapfrog_bitwise():
    """The Triton quad leapfrog (interpret mode) dispatched per shard by
    ``shard_map_chains`` over the 8-device CPU mesh equals the unsharded
    kernel bitwise: chains never communicate inside a trajectory."""
    from lhvi_tpu.ops.leapfrog import _triton_quad_leapfrog

    fg = _grid_fg()
    n = fg.n_cont
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(128, n)), jnp.float32)
    p = jnp.asarray(rng.normal(size=(128, n)), jnp.float32)
    im = jnp.ones(n, jnp.float32)
    kern = lambda x_, p_, J_, h_, im_, e_: _triton_quad_leapfrog(
        x_, p_, J_, h_, im_, e_, 6, block_chains=16, interpret=True)
    sh = chain_sharding(make_mesh(axis_names=("dp",)))
    sharded = jax.jit(shard_map_chains(kern, sh, n_sharded_args=2))
    got = sharded(x, p, fg.quad_J, fg.quad_h, im, 0.1)
    ref = jax.jit(kern)(x, p, fg.quad_J, fg.quad_h, im, 0.1)
    for a, b in zip(got, ref):
        assert (np.asarray(a) == np.asarray(b)).all()
