"""Bilinear image interpolation with linear extrapolation.

Replaces the reference's ``scipy.interpolate.RectBivariateSpline(kx=1, ky=1)``
gradient-image lookup (reference: gpet.py:122-125, evaluated at gpet.py:392).
A degree-1 tensor spline on the integer pixel grid *is* bilinear
interpolation; FITPACK clamps out-of-domain query coordinates to the grid
boundary per axis (verified empirically against scipy), so coordinates are
clipped before interpolation.

Pure gather + FMA; vmap/jit friendly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def bilinear_interp(img, rows, cols):
    """Evaluate ``img`` at real-valued ``(rows, cols)`` coordinates.

    Equivalent to ``RectBivariateSpline(arange(M), arange(N), img, kx=1,
    ky=1)(rows, cols, grid=False)`` including the boundary clamp applied to
    out-of-domain coordinates.
    """
    img = jnp.asarray(img)
    M, N = img.shape
    rows = jnp.clip(jnp.asarray(rows), 0, M - 1)
    cols = jnp.clip(jnp.asarray(cols), 0, N - 1)

    r0 = jnp.clip(jnp.floor(rows), 0, M - 2).astype(jnp.int32)
    c0 = jnp.clip(jnp.floor(cols), 0, N - 2).astype(jnp.int32)
    fr = rows - r0
    fc = cols - c0

    v00 = img[r0, c0]
    v01 = img[r0, c0 + 1]
    v10 = img[r0 + 1, c0]
    v11 = img[r0 + 1, c0 + 1]

    top = v00 + fc * (v01 - v00)
    bot = v10 + fc * (v11 - v10)
    return top + fr * (bot - top)


@functools.partial(jax.jit, static_argnames=("add_const",))
def column_interp(cols, ys, add_const=0.0):
    """Linear interpolation of ``cols[e, :]`` at rows ``ys[e, :]``.

    The curve cost's gradient lookup: curve x-coordinates are exactly the
    integer grid columns, so :func:`bilinear_interp` degenerates to a 1-D
    interpolation down each column — two gathers from the (E, M) column
    table, with the same boundary clamp.

    Args:
      cols: (E, M) per-column pixel values (``grad_img.T`` rows).
      ys: (E, S) real-valued row coordinates (clamped to [0, M-1]).
      add_const: static scalar added to every output (the curve cost's
        ``kde_thresh`` floor), fused into the same elementwise pass.

    Returns:
      (E, S) interpolated values in ``cols.dtype``.
    """
    E, M = cols.shape
    y = jnp.clip(ys, 0, M - 1)
    r0 = jnp.clip(jnp.floor(y), 0, M - 2).astype(jnp.int32)
    fr = (y - r0).astype(cols.dtype)
    v0 = jnp.take_along_axis(cols, r0, axis=1)
    v1 = jnp.take_along_axis(cols, r0 + 1, axis=1)
    res = v0 + fr * (v1 - v0)
    return res + add_const if add_const else res
