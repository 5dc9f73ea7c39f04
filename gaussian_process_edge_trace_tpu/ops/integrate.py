"""Composite Simpson quadrature on (possibly) non-uniform grids.

Replaces the reference's ``scipy.integrate.simps`` calls in the curve cost
function (reference: gpet.py:404-405). Implemented as closed-form weighted
sums over statically-shaped arrays so a whole batch of curves reduces to
dot products and fused reductions (SURVEY.md §7 step 4).

Semantics match ``scipy.integrate.simpson``:

- odd number of points: classic composite Simpson over consecutive interval
  pairs, with the non-uniform three-point formula;
- even number of points: Simpson over the leading odd block plus the
  Cartwright-corrected last interval (scipy >= 1.11 default), or — with
  ``even="avg"`` — the historical ``scipy.integrate.simps`` default the
  genuine upstream called (gpet.py:404-405): the average of (Simpson on
  the first n−1 points + trapezoid on the last interval) and (trapezoid
  on the first interval + Simpson on the last n−1 points). The two rules
  differ by one trailing-interval term per quadrature; the flag exists
  for bit-faithful cost parity with old-scipy runs of the reference.
"""

from __future__ import annotations

import jax.numpy as jnp


def _pair_contributions(y0, y1, y2, h0, h1):
    """Non-uniform Simpson contribution of one interval pair.

    Integral over [x0, x2] through (x0,y0),(x1,y1),(x2,y2) with
    h0 = x1-x0, h1 = x2-x1 (scipy's ``_basic_simpson`` formula).
    """
    hsum = h0 + h1
    return (hsum / 6.0) * (
        y0 * (2.0 - h1 / h0)
        + y1 * hsum * hsum / (h0 * h1)
        + y2 * (2.0 - h0 / h1)
    )


def simpson_nonuniform(y, x=None, axis=-1, even="simpson", h=None):
    """Composite Simpson integral of samples ``y`` at locations ``x``.

    ``y`` and ``x`` must have the same static length along ``axis``
    (length >= 2); broadcasting over leading batch axes is supported when
    ``axis == -1``. ``even`` ∈ {"simpson", "avg"} selects the
    even-point-count rule (module docstring).

    The quadrature consumes ``x`` only through the interval widths
    ``diff(x)``; callers that already hold those widths may pass them as
    ``h`` (one element shorter than ``y``) instead of ``x``. The curve
    cost builds its curvilinear coordinate as ``cumsum(step)``
    (gpet.py:397), so its widths ARE the steps — passing them directly
    skips an O(E·S) cumsum (XLA lowers it to wide reduce-windows) plus
    its re-differencing, which together dominated the batched-serving
    quadrature tail. ``diff(cumsum(step))`` re-rounds each width in f32,
    so the two call forms agree to rounding (~1 ulp per width), not
    bitwise.
    """
    y = jnp.asarray(y)
    if (x is None) == (h is None):
        raise ValueError("pass exactly one of x / h")
    if axis == 0 and y.ndim > 1:
        # Native leading-axis path: slicing/reducing axis 0 keeps the
        # batch on the minor axis with NO transpose, where the generic
        # path's moveaxis materialises a full copy of every operand (the
        # curve cost's (E, S) samples, trace/scoring.py). Same
        # contributions, reduced along axis 0.
        if x is not None:
            h0 = jnp.diff(jnp.asarray(x), axis=0)
        else:
            h0 = jnp.asarray(h)
        return _simpson_axis0(y, h0, even)
    if x is not None:
        x = jnp.asarray(x)
        if axis != -1:
            x = jnp.moveaxis(x, axis, -1)
    else:
        h = jnp.asarray(h)
        if axis != -1:
            h = jnp.moveaxis(h, axis, -1)
    if axis != -1:
        y = jnp.moveaxis(y, axis, -1)
    n = y.shape[-1]
    if n < 2:
        raise ValueError("simpson needs at least 2 samples")
    if h is not None and h.shape[-1] != n - 1:
        raise ValueError(f"h must have n-1 = {n - 1} intervals, "
                         f"got {h.shape[-1]}")
    if n == 2:
        w = (x[..., 1] - x[..., 0]) if h is None else h[..., 0]
        return 0.5 * (y[..., 0] + y[..., 1]) * w

    if h is None:
        h = jnp.diff(x, axis=-1)

    def _odd_block(yb, hb):
        # yb has odd length m = 2k+1; integrate over k pairs.
        y0 = yb[..., 0:-2:2]
        y1 = yb[..., 1:-1:2]
        y2 = yb[..., 2::2]
        h0 = hb[..., 0::2]
        h1 = hb[..., 1::2]
        return jnp.sum(_pair_contributions(y0, y1, y2, h0, h1), axis=-1)

    if n % 2 == 1:
        return _odd_block(y, h)

    if even == "avg":
        # Historical scipy `simps` default (gpet.py:404-405).
        first = (_odd_block(y[..., : n - 1], h[..., : n - 2])
                 + 0.5 * (y[..., -1] + y[..., -2]) * h[..., -1])
        second = (0.5 * (y[..., 0] + y[..., 1]) * h[..., 0]
                  + _odd_block(y[..., 1:], h[..., 1:]))
        return 0.5 * (first + second)

    # Even number of points: Simpson on points [0, n-2] (odd count) plus the
    # Cartwright correction on the trailing interval, mirroring scipy's
    # even='simpson' composite rule (the modern >=1.11 default, which the
    # installed scipy — and hence the CPU parity oracle — uses). The genuine
    # upstream called scipy.integrate.simps whose historical default was
    # even='avg'; the difference is one trailing-interval term per
    # quadrature, far below every metric tolerance in the pipeline, and is
    # documented rather than reproduced.
    main = _odd_block(y[..., : n - 1], h[..., : n - 2])
    h0 = h[..., -2]
    h1 = h[..., -1]
    # scipy correction coefficients for the last interval.
    alpha = (2 * h1 * h1 + 3 * h0 * h1) / (6 * (h0 + h1))
    beta = (h1 * h1 + 3 * h0 * h1) / (6 * h0)
    eta = h1 * h1 * h1 / (6 * h0 * (h0 + h1))
    tail = alpha * y[..., -1] + beta * y[..., -2] - eta * y[..., -3]
    return main + tail


def _simpson_axis0(y, h, even):
    """:func:`simpson_nonuniform` body specialised to ``axis=0``
    (transpose-free; see the dispatch comment there)."""
    n = y.shape[0]
    if n < 2:
        raise ValueError("simpson needs at least 2 samples")
    if h.shape[0] != n - 1:
        raise ValueError(f"h must have n-1 = {n - 1} intervals, "
                         f"got {h.shape[0]}")
    if h.ndim < y.ndim:
        # 1-D x/h against batched y: the intervals broadcast along axis 0,
        # so they need explicit trailing batch axes (the generic moveaxis
        # path gets this for free from trailing-dim broadcasting).
        h = h.reshape(h.shape + (1,) * (y.ndim - h.ndim))
    if n == 2:
        return 0.5 * (y[0] + y[1]) * h[0]

    def _odd_block(yb, hb):
        # Masked shifted windows instead of stride-2 slices: a stride-2
        # slice along the major axis of an (E, S) array can lower as a
        # gather. Evaluating the pair formula at EVERY window from
        # contiguous unit-stride slices and zeroing the odd starts costs
        # 2× the flops but no gather; each kept term's arithmetic is
        # unchanged.
        # ``where`` (not multiply) so division hazards at never-selected
        # windows (e.g. h=0 from a repeated x) cannot leak NaNs.
        m = yb.shape[0]                          # odd, >= 3
        contrib = _pair_contributions(
            yb[:-2], yb[1:-1], yb[2:], hb[:-1], hb[1:])
        mask = (jnp.arange(m - 2) % 2 == 0).reshape(
            (m - 2,) + (1,) * (contrib.ndim - 1))
        return jnp.sum(jnp.where(mask, contrib, jnp.zeros((), yb.dtype)),
                       axis=0)

    if n % 2 == 1:
        return _odd_block(y, h)

    if even == "avg":
        first = (_odd_block(y[: n - 1], h[: n - 2])
                 + 0.5 * (y[-1] + y[-2]) * h[-1])
        second = (0.5 * (y[0] + y[1]) * h[0]
                  + _odd_block(y[1:], h[1:]))
        return 0.5 * (first + second)

    main = _odd_block(y[: n - 1], h[: n - 2])
    h0 = h[-2]
    h1 = h[-1]
    alpha = (2 * h1 * h1 + 3 * h0 * h1) / (6 * (h0 + h1))
    beta = (h1 * h1 + 3 * h0 * h1) / (6 * h0)
    eta = h1 * h1 * h1 / (6 * h0 * (h0 + h1))
    return main + alpha * y[-1] + beta * y[-2] - eta * y[-3]


def simpson_weights(x, even="simpson"):
    """Return weights ``w`` with ``simpson(y, x) == y @ w`` for fixed ``x``.

    Useful when the sample locations are static (e.g. the uniform arc-length
    grid at gpet.py:405) so the quadrature becomes a single dot product.
    Closed form: the per-pair coefficients of :func:`_pair_contributions`
    scattered onto the point grid (plus the Cartwright tail for even n, or
    the historical trapezoid-average with ``even="avg"``).
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    if n < 2:
        raise ValueError("simpson needs at least 2 samples")
    if n == 2:
        h = x[1] - x[0]
        return jnp.stack([0.5 * h, 0.5 * h])
    h = jnp.diff(x)
    w = jnp.zeros(n, dtype=x.dtype)

    def add_odd_block(w, m):
        # Pairs over points [0, m); m odd.
        h0 = h[0:m - 2:2]
        h1 = h[1:m - 1:2]
        hsum = h0 + h1
        c0 = (hsum / 6.0) * (2.0 - h1 / h0)
        c1 = (hsum / 6.0) * (hsum * hsum / (h0 * h1))
        c2 = (hsum / 6.0) * (2.0 - h0 / h1)
        w = w.at[0:m - 2:2].add(c0)
        w = w.at[1:m - 1:2].add(c1)
        w = w.at[2:m:2].add(c2)
        return w

    if n % 2 == 1:
        return add_odd_block(w, n)
    if even == "avg":
        w1 = add_odd_block(w, n - 1)
        w1 = w1.at[-1].add(0.5 * h[-1]).at[-2].add(0.5 * h[-1])
        w2 = jnp.concatenate([jnp.zeros((1,), x.dtype),
                              simpson_weights(x[1:])])
        w2 = w2.at[0].add(0.5 * h[0]).at[1].add(0.5 * h[0])
        return 0.5 * (w1 + w2)
    w = add_odd_block(w, n - 1)
    h0, h1 = h[-2], h[-1]
    alpha = (2 * h1 * h1 + 3 * h0 * h1) / (6 * (h0 + h1))
    beta = (h1 * h1 + 3 * h0 * h1) / (6 * h0)
    eta = h1 * h1 * h1 / (6 * h0 * (h0 + h1))
    w = w.at[-1].add(alpha)
    w = w.at[-2].add(beta)
    w = w.at[-3].add(-eta)
    return w
