"""Posterior-curve cost function and top-k ranking.

Replaces the reference's serial per-sample Python loop
(reference: gpet.py:414-451 looping gpet.py:371-410) with one batched
computation over all N_samples curves: per-column interpolation of the
gradient image, closed-form Simpson quadratures over the whole batch, and
``lax.top_k`` column extraction. On an NVIDIA GPU the interpolation and
both quadratures run as one Pallas kernel (ops/fused_cost.py) that never
writes an (E, S) intermediate.

Cost semantics (gpet.py:392-408), for a curve (x_grid, y) with unit x
spacing:

- gradient score along the curve: bilinear lookup of the gradient image at
  (y, x) plus the ``kde_thresh`` floor (x-coordinates are exactly the
  integer grid columns, so the bilinear lookup is a per-column linear
  interpolation);
- curvilinear coordinate: cumulative Euclidean step length
  ``cumsum(sqrt(1 + dy^2))`` (dx = 1 on the tiled grid, gpet.py:397);
- arc-length integrand: ``sqrt(1 + y'^2)`` with forward differencing
  (gpet.py:400-401) — identical to the step lengths on a unit grid;
- ``cost = simpson(integrand, x[:-1]) / simpson(grad_score[:-1],
  curvilinear)`` (gpet.py:404-408); lower is better.

The reference sorts each curve by x first (gpet.py:391); sampled curves
live on the already-sorted x_grid so the sort is the identity and is
elided here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gaussian_process_edge_trace_tpu.ops.fused_cost import fused_curve_costs
from gaussian_process_edge_trace_tpu.ops.integrate import (
    simpson_nonuniform, simpson_weights)
from gaussian_process_edge_trace_tpu.ops.interp import column_interp


def use_fused_cost(E: int) -> bool:
    """The choice between the fused kernel and the plain ``jnp`` curve
    cost: the kernel on a GPU for every grid of at least 4 columns, the
    plain path elsewhere. On the GPU a sample's cost from the kernel does
    not depend on how many samples are scored with it, which the exact
    sample-sharded trace relies on (parallel/sharded.py)."""
    return jax.default_backend() == "gpu" and E >= 4


@functools.partial(jax.jit, static_argnames=("kde_thresh", "even"))
def curve_costs(grad_img, x_grid, y_samples, kde_thresh: float = 1e-3,
                cols=None, even: str = "simpson"):
    """Costs of all sampled curves.

    Args:
      grad_img: (M, N) normalised gradient image.
      x_grid: (E,) integer grid columns (sorted, contiguous).
      y_samples: (E, S) posterior curves.
      cols: optional precomputed (E, M) per-column pixel values
        (``grad_img.T`` sliced to the x-grid). Pass the loop-invariant
        ``TracerData.grad_cols`` inside the trace loop so the transpose is
        not rebuilt every iteration.
      even: even-point Simpson rule; ``"avg"`` reproduces the historical
        ``scipy.integrate.simps`` default the upstream called
        (gpet.py:404-405) bit-faithfully.

    Returns:
      (S,) costs (lower = better).
    """
    E = y_samples.shape[0]
    M = grad_img.shape[0]

    if cols is None:
        # Gradient values along every curve: slice the E contiguous
        # columns (no gather).
        cols = jax.lax.dynamic_slice(
            grad_img.T, (x_grid[0], jnp.zeros((), x_grid.dtype)), (E, M))

    if use_fused_cost(E):
        return fused_curve_costs(cols, y_samples, kde_thresh=kde_thresh,
                                 even=even).astype(y_samples.dtype)
    return plain_curve_costs(cols, x_grid, y_samples, kde_thresh, even)


def plain_curve_costs(cols, x_grid, y_samples, kde_thresh: float = 1e-3,
                      even: str = "simpson"):
    """:func:`curve_costs` in plain ``jnp`` on the (E, M) columns ``cols``
    — the path off the GPU, and the GPU kernel's reference."""
    dtype = y_samples.dtype
    grad_score = column_interp(
        cols, y_samples, add_const=kde_thresh).astype(dtype)

    dy = jnp.diff(y_samples, axis=0)                  # (E-1, S)
    step = jnp.sqrt(1.0 + dy * dy)                    # Euclid = integrand
    # The curvilinear coordinate (gpet.py:397) is cumsum(step); Simpson
    # consumes it only through its interval widths diff(cumsum(step)) ==
    # step[1:], so the widths are passed directly — the cumsum and its
    # re-differencing never materialise. Agrees with the
    # explicit-coordinate form to f32 rounding of each width (~1 ulp).
    line_integral = simpson_nonuniform(grad_score[:-1], h=step[1:],
                                       even=even, axis=0)

    # Arc-length Simpson weights are static in x (uniform unit spacing
    # over x_grid[:-1]) so that quadrature is one weighted reduce for the
    # batch, which XLA fuses with the pass that reads ``step``.
    arc_w = simpson_weights(x_grid[:-1].astype(dtype), even=even)
    arc_length = jnp.sum(arc_w[:, None] * step, axis=0)   # (S,)
    return arc_length / line_integral


@functools.partial(jax.jit, static_argnames=("n_keep",))
def best_curves(y_samples, costs, n_keep: int):
    """Top ``n_keep`` curves by ascending cost (gpet.py:443-449).

    Returns ``(best (E, n_keep), best_costs (n_keep,))``; index 0 is the
    optimum. Extraction is a plain column ``take``.
    """
    neg, idx = jax.lax.top_k(-costs, n_keep)
    return jnp.take(y_samples, idx, axis=1), -neg
