"""Triton quad leapfrog (``ops/leapfrog.py``) on the CPU in interpret mode.

The kernel must match the XLA body (``_jnp_quad_leapfrog``) at f32 and a
float64 numpy leapfrog, keep its padding lanes and rows inert, and the
dispatcher must pick it only on a GPU and only for a J that fits on chip.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lhvi_tpu.ops import leapfrog as lf


def _problem(C, n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    J = (A @ A.T / n + np.eye(n)).astype(np.float32)
    x = rng.normal(size=(C, n)).astype(np.float32)
    p = rng.normal(size=(C, n)).astype(np.float32)
    h = rng.normal(size=n).astype(np.float32)
    im = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, p, J, h, im


def _f64_leapfrog(x, p, J, h, im, eps, n_steps):
    x, p, J, h, im = (np.asarray(a, np.float64) for a in (x, p, J, h, im))
    p = p + 0.5 * eps * (h - x @ J)
    for i in range(n_steps):
        x = x + eps * im * p
        p = p + (0.5 if i == n_steps - 1 else 1.0) * eps * (h - x @ J)
    return x, p


# (C, n, n_steps): C not a multiple of the block, n not a power of two,
# n below the 16-wide dot minimum, and the 80-latent headline width
@pytest.mark.parametrize("C,n,n_steps", [
    (64, 32, 8), (40, 20, 8), (33, 80, 8), (16, 5, 3), (100, 128, 1),
])
def test_triton_leapfrog_matches_xla_and_f64(C, n, n_steps):
    x, p, J, h, im = _problem(C, n)
    eps = 0.12
    kx, kp = lf._triton_quad_leapfrog(x, p, J, h, im, eps, n_steps,
                                      block_chains=16, interpret=True)
    rx, rp = lf._jnp_quad_leapfrog(x, p, J, h, im, eps, n_steps)
    np.testing.assert_allclose(np.asarray(kx), np.asarray(rx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(kp), np.asarray(rp),
                               rtol=1e-5, atol=1e-5)
    fx, fp = _f64_leapfrog(x, p, J, h, im, eps, n_steps)
    for a in (kx, rx):
        np.testing.assert_allclose(np.asarray(a), fx, rtol=1e-4, atol=1e-4)
    for a in (kp, rp):
        np.testing.assert_allclose(np.asarray(a), fp, rtol=1e-4, atol=1e-4)


def test_triton_leapfrog_padding_inert():
    """Rows past C and lanes past n are masked on load and store: the
    output buffers hold exactly C×n values, and garbage (NaN) in an
    unrelated chain block or a huge value in the last real lane cannot
    leak into other chains."""
    C, n = 20, 12
    x, p, J, h, im = _problem(C, n, seed=1)
    x[17, :] = np.nan  # lives in the second (partial) block of 16
    kx, kp = lf._triton_quad_leapfrog(x, p, J, h, im, 0.1, 4,
                                      block_chains=16, interpret=True)
    assert kx.shape == (C, n) and kp.shape == (C, n)
    rx, rp = lf._jnp_quad_leapfrog(x, p, J, h, im, 0.1, 4)
    ok = np.ones(C, bool)
    ok[17] = False
    assert np.isfinite(np.asarray(kx)[ok]).all()
    np.testing.assert_allclose(np.asarray(kx)[ok], np.asarray(rx)[ok],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(kp)[ok], np.asarray(rp)[ok],
                               rtol=1e-5, atol=1e-5)


def test_kernel_choice_by_backend():
    assert lf.use_triton(80, backend="gpu")
    assert not lf.use_triton(80, backend="cpu")
    # this process runs on the CPU: the default backend takes XLA, and
    # quad_leapfrog returns the XLA body's result exactly
    assert not lf.use_triton(80)
    x, p, J, h, im = _problem(8, 6)
    got = lf.quad_leapfrog(x, p, J, h, im, 0.1, 3)
    ref = lf._jnp_quad_leapfrog(x, p, J, h, im, 0.1, 3)
    for a, b in zip(got, ref):
        assert (np.asarray(a) == np.asarray(b)).all()


def test_kernel_shape_route_to_xla():
    """A dense J whose padded width would not fit in shared memory takes
    the XLA body even on a GPU."""
    assert lf.use_triton(lf.TRITON_MAX_N, backend="gpu")
    assert not lf.use_triton(lf.TRITON_MAX_N + 1, backend="gpu")
    assert lf._pad_width(lf.TRITON_MAX_N) == lf.TRITON_MAX_N
    assert lf._pad_width(5) == 16 and lf._pad_width(80) == 128
