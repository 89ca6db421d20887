"""SMC weight pipeline (``ops/resample.py``): log-weight normalization,
ESS and the cumulative-weight scan feeding systematic resampling, checked
against float64 numpy and hand math.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lhvi_tpu.ops import resample as rs


@pytest.mark.parametrize("n", [7, 128, 1000])
def test_weight_pipeline_matches_float64(n):
    """f32 pipeline vs the same math in float64 numpy, plus the
    normalization invariants the resampler relies on."""
    rng = np.random.default_rng(0)
    lw64 = rng.normal(scale=3.0, size=n)
    lwn, cum, z, ess = rs.weight_pipeline(jnp.asarray(lw64, jnp.float32))
    m = lw64.max()
    w = np.exp(lw64 - m)
    z64 = m + np.log(w.sum())
    wn = w / w.sum()
    np.testing.assert_allclose(np.asarray(lwn), lw64 - z64, atol=1e-5)
    np.testing.assert_allclose(np.asarray(cum), np.cumsum(wn), atol=1e-5)
    np.testing.assert_allclose(float(z), z64, atol=1e-5)
    np.testing.assert_allclose(float(ess), 1.0 / np.sum(wn * wn), rtol=1e-5)
    np.testing.assert_allclose(float(cum[-1]), 1.0, atol=1e-5)
    assert 1.0 - 1e-4 <= float(ess) <= n * (1 + 1e-4)


def test_jnp_pipeline_hand_math():
    lw = jnp.asarray([0.0, jnp.log(3.0), 0.0])  # weights ∝ [1, 3, 1]
    lwn, cum, z, ess = rs.weight_pipeline(lw)
    w = np.array([0.2, 0.6, 0.2])
    np.testing.assert_allclose(np.exp(np.asarray(lwn)), w, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(cum), np.cumsum(w), rtol=1e-6)
    np.testing.assert_allclose(float(z), np.log(5.0), rtol=1e-6)
    np.testing.assert_allclose(float(ess), 1.0 / np.sum(w * w), rtol=1e-6)


def test_systematic_parents_matches_engine_resampler():
    from lhvi_tpu.engines.smc import systematic_resample

    rng = np.random.default_rng(1)
    n = 512
    lw = jnp.asarray(rng.normal(size=n).astype(np.float32))
    lwn, cum, _, _ = rs.weight_pipeline(lw)
    key = jax.random.PRNGKey(7)
    idx_new = rs.systematic_parents(key, cum, n)
    idx_old = systematic_resample(key, lwn, n)
    np.testing.assert_array_equal(np.asarray(idx_new), np.asarray(idx_old))
    # unbiasedness sanity: offspring counts track n·w within ±1
    w = np.exp(np.asarray(lwn))
    counts = np.bincount(np.asarray(idx_new), minlength=n)
    assert np.all(np.abs(counts - n * w) <= 1.0 + 1e-6)
