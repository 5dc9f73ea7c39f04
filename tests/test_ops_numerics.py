"""Tests for Simpson quadrature and bilinear interpolation vs scipy oracles."""

import numpy as np
import pytest
import scipy.integrate
import scipy.interpolate

from gaussian_process_edge_trace_tpu.ops import (
    simpson_nonuniform, simpson_weights, bilinear_interp)


@pytest.mark.parametrize("n", [3, 5, 11, 499, 4, 6, 500])
def test_simpson_uniform(n):
    x = np.linspace(0.0, 3.0, n)
    y = np.sin(x) + 0.3 * x ** 2
    expected = scipy.integrate.simpson(y, x=x)
    got = float(simpson_nonuniform(y, x))
    np.testing.assert_allclose(got, expected, rtol=1e-5)


@pytest.mark.parametrize("n", [3, 5, 11, 499, 4, 6, 500])
def test_simpson_nonuniform(n):
    rng = np.random.RandomState(n)
    x = np.cumsum(0.1 + rng.rand(n))
    y = np.cos(x) * x
    expected = scipy.integrate.simpson(y, x=x)
    got = float(simpson_nonuniform(y, x))
    np.testing.assert_allclose(got, expected, rtol=1e-5)


def test_simpson_two_points_is_trapezoid():
    x = np.array([1.0, 2.5])
    y = np.array([2.0, 4.0])
    np.testing.assert_allclose(float(simpson_nonuniform(y, x)), 4.5, rtol=1e-6)


def test_simpson_batched():
    rng = np.random.RandomState(0)
    x = np.cumsum(0.1 + rng.rand(7, 99), axis=-1)
    y = rng.randn(7, 99)
    got = np.asarray(simpson_nonuniform(y, x))
    for i in range(7):
        np.testing.assert_allclose(
            got[i], scipy.integrate.simpson(y[i], x=x[i]), rtol=1e-4)


@pytest.mark.parametrize("even", ["simpson", "avg"])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 499, 500])
@pytest.mark.parametrize("width", [3, 4])
def test_simpson_axis0_matches_generic(n, even, width):
    """The transpose-free axis=0 fast path equals the generic moveaxis
    path for every point-count parity, both even rules, 2-D h, and the
    1-D-x-against-batched-y broadcast form (width == pair count k is the
    shape where a wrong-axis broadcast once returned silently wrong
    integrals instead of raising)."""
    rng = np.random.RandomState(n + width)
    x2 = np.cumsum(0.1 + rng.rand(n, width), axis=0)
    y2 = rng.randn(n, width)
    got = np.asarray(simpson_nonuniform(y2, x2, axis=0, even=even))
    ref = np.asarray(simpson_nonuniform(y2.T, x2.T, even=even))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    # 1-D shared coordinates against batched samples.
    x1 = np.cumsum(0.1 + rng.rand(n))
    got1 = np.asarray(simpson_nonuniform(y2, x1, axis=0, even=even))
    ref1 = np.asarray(simpson_nonuniform(
        y2.T, np.broadcast_to(x1, (width, n)), even=even))
    np.testing.assert_allclose(got1, ref1, rtol=1e-12)
    if n > 2 and (n % 2 == 1 or even == "simpson"):
        # scipy >= 1.11 implements only the Cartwright even rule, so the
        # historical 'avg' rule can't be cross-checked there at even n.
        for i in range(width):
            np.testing.assert_allclose(
                got1[i], scipy.integrate.simpson(y2[:, i], x=x1),
                rtol=1e-9)
    # h-form on axis 0.
    goth = np.asarray(simpson_nonuniform(
        y2, h=np.diff(x2, axis=0), axis=0, even=even))
    np.testing.assert_allclose(goth, ref, rtol=1e-12)


@pytest.mark.parametrize("even", ["simpson", "avg"])
@pytest.mark.parametrize("n", [2, 3, 5, 499, 4, 6, 500])
def test_simpson_h_form_matches_x_form(n, even):
    """Passing interval widths directly (h=) equals passing coordinates —
    the curve-cost path hands Simpson its cumsum-free steps this way."""
    rng = np.random.RandomState(n)
    h = 0.1 + rng.rand(n - 1)
    x = np.concatenate([[0.5], 0.5 + np.cumsum(h)])
    y = np.cos(x) * x
    via_x = float(simpson_nonuniform(y, x, even=even))
    via_h = float(simpson_nonuniform(y, h=h, even=even))
    np.testing.assert_allclose(via_h, via_x, rtol=1e-12)
    with pytest.raises(ValueError):
        simpson_nonuniform(y, x, h=h)
    with pytest.raises(ValueError):
        simpson_nonuniform(y)
    with pytest.raises(ValueError):
        simpson_nonuniform(y, h=h[:-1])


def test_simpson_weights_dot_product():
    x = np.linspace(0, 1, 9)
    w = np.asarray(simpson_weights(x))
    rng = np.random.RandomState(1)
    y = rng.randn(9)
    np.testing.assert_allclose(
        float(y @ w), scipy.integrate.simpson(y, x=x), rtol=1e-5)


def test_bilinear_matches_rectbivariatespline_interior():
    rng = np.random.RandomState(2)
    img = rng.rand(40, 50)
    spline = scipy.interpolate.RectBivariateSpline(
        np.arange(40), np.arange(50), img, kx=1, ky=1)
    rows = rng.rand(200) * 39
    cols = rng.rand(200) * 49
    expected = spline(rows, cols, grid=False)
    got = np.asarray(bilinear_interp(img, rows, cols))
    np.testing.assert_allclose(got, expected, atol=1e-6)


def test_bilinear_extrapolation_matches_spline():
    # RectBivariateSpline(kx=ky=1) extrapolates linearly outside the grid;
    # posterior curves routinely leave the image (gpet.py:392 evaluates them
    # anyway), so parity outside the domain matters.
    rng = np.random.RandomState(3)
    img = rng.rand(20, 25)
    spline = scipy.interpolate.RectBivariateSpline(
        np.arange(20), np.arange(25), img, kx=1, ky=1)
    rows = np.array([-5.3, -0.1, 0.0, 19.0, 19.7, 30.2, 10.5])
    cols = np.array([-2.0, 3.3, 24.9, 25.8, -0.5, 12.0, 24.0])
    expected = spline(rows, cols, grid=False)
    got = np.asarray(bilinear_interp(img, rows, cols))
    np.testing.assert_allclose(got, expected, atol=1e-6)


@pytest.mark.parametrize("E,M,S", [(24, 72, 96), (16, 600, 64),
                                   (16, 600, 2000)])
def test_column_interp_matches_np_interp(E, M, S):
    """column_interp (the curve cost's gradient lookup) equals a per-column
    np.interp, including the clamp at both image edges: y below 0 reads
    row 0 and y above M-1 reads row M-1."""
    import jax.numpy as jnp

    from gaussian_process_edge_trace_tpu.ops import column_interp

    rng = np.random.default_rng(0)
    cols = rng.random((E, M))
    ys = np.concatenate([
        rng.random((E, S - 16)) * (M - 1),
        rng.integers(0, M, (E, 8)).astype(float),
        rng.uniform(-3, M + 3, (E, 8))], axis=1)
    ys[:, 0], ys[:, 1] = -5.0, M + 5.0
    got = np.asarray(column_interp(jnp.asarray(cols), jnp.asarray(ys),
                                   add_const=1e-3))
    want = np.stack([np.interp(ys[e], np.arange(M), cols[e])
                     for e in range(E)]) + 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[:, 0], cols[:, 0] + 1e-3, rtol=1e-12)
    np.testing.assert_allclose(got[:, 1], cols[:, -1] + 1e-3, rtol=1e-12)
