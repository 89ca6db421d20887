"""Unit tests: potential kernels vs scipy/numpy closed forms (SURVEY.md §5.1)."""

import numpy as np
import pytest
from scipy import stats

from lhvi_tpu.potentials import (
    GaussianPotential,
    LinearGaussianPotential,
    QuadraticPotential,
    TablePotential,
    MLNPotential,
    ImageNodePotential,
    ImageEdgePotential,
    XYPotential,
)


def test_gaussian_matches_scipy():
    mu = [0.5, -1.0]
    sig = [[2.0, 0.3], [0.3, 1.0]]
    p = GaussianPotential(mu, sig)
    x = np.array([0.7, -2.0])
    want = stats.multivariate_normal(mu, sig).logpdf(x)
    got = p.log_value([0.7, -2.0], (True, True))
    assert np.isclose(got, want, atol=1e-5)


def test_gaussian_unnormalized():
    p = GaussianPotential([0.0], [[1.0]], normalized=False)
    assert np.isclose(p.log_value([2.0], (True,)), -2.0, atol=1e-6)


def test_linear_gaussian():
    p = LinearGaussianPotential(coeff=2.0, sig=0.5)
    # log φ = -(y - 2x)^2 / (2*0.5)
    got = p.log_value([1.0, 3.0], (True, True))
    assert np.isclose(got, -(3.0 - 2.0) ** 2 / 1.0, atol=1e-6)


def test_quadratic():
    p = QuadraticPotential(A=[[-0.5]], b=[1.0], c=2.0)
    got = p.log_value([3.0], (True,))
    assert np.isclose(got, -0.5 * 9 + 3 + 2, atol=1e-5)


def test_xy():
    p = XYPotential(coeff=2.0, sig=4.0)
    assert np.isclose(p.log_value([3.0, -1.0], (True, True)), -1.5, atol=1e-6)


def test_table():
    t = np.array([[0.1, 0.2], [0.3, 0.4]])
    p = TablePotential(t)
    for i in range(2):
        for j in range(2):
            got = p.log_value([(i, float(i)), (j, float(j))], (False, False))
            assert np.isclose(got, np.log(t[i, j]), atol=1e-6)


def test_mln_soft():
    # smokes(x) => cancer(x), weight 1.5  (soft implication on {0,1} values)
    f = lambda args: 1.0 - args[0] * (1.0 - args[1])
    p = MLNPotential(f, w=1.5, formula_name="imp")
    # violated: smokes=1, cancer=0 -> truth 0
    got = p.log_value([(1, 1.0), (0, 0.0)], (False, False))
    assert np.isclose(got, 0.0, atol=1e-6)
    got = p.log_value([(1, 1.0), (1, 1.0)], (False, False))
    assert np.isclose(got, 1.5, atol=1e-6)


def test_mln_hybrid_order():
    # formula mixes cont and disc args; order must be preserved
    f = lambda args: args[0] * args[1] + args[2]
    p = MLNPotential(f, w=2.0, formula_name="mix")
    got = p.log_value([3.0, (1, 1.0), 0.5], (True, False, True))
    assert np.isclose(got, 2.0 * (3.0 * 1.0 + 0.5), atol=1e-5)


def test_image_potentials():
    pn = ImageNodePotential(alpha=2.0)
    assert np.isclose(pn.log_value([1.0, 4.0], (True, True)), -9 / 4, atol=1e-6)
    pe = ImageEdgePotential(distance_cap=1.0, scale=2.0)
    assert np.isclose(pe.log_value([0.0, 5.0], (True, True)), -0.5, atol=1e-6)
    assert np.isclose(pe.log_value([0.0, 0.4], (True, True)), -0.2, atol=1e-6)


def test_batched_broadcasting():
    """Kernels broadcast over extra batch axes (grid/candidate dims)."""
    import jax.numpy as jnp

    p = GaussianPotential([0.0, 0.0], np.eye(2))
    kern = p.kernel((True, True))
    params = {k: jnp.asarray(v)[None, None] for k, v in p.param_arrays().items()}
    xc = jnp.zeros((5, 7, 2))
    out = kern(params, xc, jnp.zeros((5, 7, 0), jnp.int32), jnp.zeros((5, 7, 0)))
    assert out.shape == (5, 7)
    want = stats.multivariate_normal([0, 0], np.eye(2)).logpdf([0, 0])
    assert np.allclose(np.asarray(out), want, atol=1e-5)


def test_planar_kernels_match_slot_minor():
    """kernel_planar (slot-major layout) must agree with the
    slot-minor kernel on every potential that provides it."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    cases = [
        (GaussianPotential([0.5, -1.0], [[2.0, 0.3], [0.3, 1.0]]),
         (True, True)),
        (LinearGaussianPotential(coeff=1.3, sig=0.7), (True, True)),
        (QuadraticPotential(A=[[-0.5, 0.1], [0.1, -0.4]], b=[1.0, -2.0],
                            c=0.3), (True, True)),
        (XYPotential(coeff=2.0, sig=4.0), (True, True)),
        (ImageNodePotential(alpha=2.0), (True, True)),
        (ImageEdgePotential(distance_cap=1.0, scale=2.0), (True, True)),
        (MLNPotential(lambda a: a[0] * a[1] + a[2], w=2.0,
                      formula_name="mix3"), (True, False, True)),
        (MLNPotential(lambda a: a[0] * (1.0 - a[1]), w=None,
                      formula_name="hard2"), (False, False)),
    ]
    n = 16
    for pot, pattern in cases:
        planar = pot.kernel_planar(pattern)
        assert planar is not None, type(pot).__name__
        minor = pot.kernel(pattern)
        a = len(pattern)
        slots = [jnp.asarray(rng.normal(size=(n,)), jnp.float32)
                 for _ in range(a)]
        params = {k: jnp.broadcast_to(jnp.asarray(v), (n,) + np.shape(v))
                  for k, v in pot.param_arrays().items()}
        xc = jnp.stack([s for s, c in zip(slots, pattern) if c], -1) \
            if any(pattern) else jnp.zeros((n, 0))
        xdv = jnp.stack([s for s, c in zip(slots, pattern) if not c], -1) \
            if not all(pattern) else jnp.zeros((n, 0))
        xdi = jnp.zeros(xdv.shape, jnp.int32)
        want = np.asarray(minor(params, xc, xdi, xdv))
        # planar: [k, F] leaves (components x factors), [..., F] slots
        pparams = {
            k: jnp.asarray(np.asarray(v).reshape(n, -1).T)
            for k, v in params.items()
        }
        got = np.asarray(planar(pparams, [s[None, :] for s in slots]))
        assert got.shape == (1, n), type(pot).__name__
        assert np.allclose(got[0], want, atol=1e-5), type(pot).__name__
