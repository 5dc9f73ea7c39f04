"""Pixel scoring, adaptive thresholding, and per-bin non-max suppression.

Replaces ``get_best_pixels`` + ``compute_new_obs`` (reference:
gpet.py:532-662). The reference's dynamic-shape pipeline —
``argwhere`` candidates, concatenated old/new lists, ``np.unique`` bins and
a per-bin Python loop — becomes dense fixed-shape grid arithmetic:

- candidate pixels are a boolean (M, N) mask (``kde > kde_thresh``, with
  the fixed-endpoint column exclusion, gpet.py:651-657);
- previous observations are rescored through the same dense grids; ones no
  longer intersected by the new best curves (kde <= kde_thresh) drop out
  (gpet.py:568-574). Old observations bypass the endpoint-column exclusion
  exactly as in the reference (the exclusion is applied only to the
  argwhere candidates); duplicates (an old obs that is also a candidate)
  score identically so the per-bin argmax is unchanged;
- ``score = (kde*grad + kde + grad) / 3`` on the whole grid (gpet.py:582);
- the adaptive score threshold loop (gpet.py:589-609) is a
  ``lax.while_loop`` carrying ``score_thresh`` in state — including the
  quirk that the first pass does NOT decay the threshold (gpet.py:594-595)
  — plus a decay cap so a fully-exhausted candidate set terminates instead
  of looping forever (SURVEY.md §5 failure-detection note);
- binning ``round((x - x_st)/delta_x)`` (gpet.py:605-606; NumPy and XLA
  both round half-to-even) and the per-bin argmax (gpet.py:613-616) become
  a static column→bin map and two masked argmax reductions. The selected
  observations are returned as fixed-capacity per-bin buffers
  ``(x, y, valid)`` — one slot per bin over the full image width, the
  natural padded representation of "one pixel per occupied sub-interval".

Tie-breaking inside a bin differs from the reference only on exact float
score ties (reference: first in old-obs-then-row-major order; here:
smallest y, then smallest x), which has probability ~0 for continuous
scores.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class BinSpec(NamedTuple):
    """Static description of the sub-interval binning over the image width.

    ``bin_of_col[x] = round((x - x_st)/delta_x) - bin_min`` for every image
    column; ``n_bins`` spans the whole width because KDE mass (and user
    observations) can fall outside [x_st, x_en] (gpet.py:651).
    """
    x_st: int
    x_en: int
    delta_x: int
    bin_min: int
    n_bins: int


def make_bin_spec(N: int, x_st: int, x_en: int, delta_x: int) -> BinSpec:
    import numpy as np
    cols = np.arange(N)
    bins = np.round((cols - x_st) / delta_x).astype(int)  # round-half-even
    bin_min = int(bins.min())
    n_bins = int(bins.max()) - bin_min + 1
    return BinSpec(x_st=x_st, x_en=x_en, delta_x=delta_x,
                   bin_min=bin_min, n_bins=n_bins)


def _bin_of_col(spec: BinSpec, N: int):
    cols = jnp.arange(N, dtype=jnp.float32)
    return (jnp.round((cols - spec.x_st) / spec.delta_x).astype(jnp.int32)
            - spec.bin_min)


class Selection(NamedTuple):
    obs_x: jnp.ndarray       # (n_bins,) int32, x of best pixel per bin
    obs_y: jnp.ndarray       # (n_bins,) int32
    obs_valid: jnp.ndarray   # (n_bins,) bool — bin occupied
    n_fobs: jnp.ndarray      # scalar int32 = sum(obs_valid)
    score_thresh: jnp.ndarray  # scalar, post-decay (persistent state,
    #                            gpet.py:595 mutates self.score_thresh)


@functools.partial(
    jax.jit,
    static_argnames=("spec", "fix_endpoints", "kde_thresh", "pixel_thresh",
                     "algo_thresh", "max_decays"))
def select_pixels(kde_arr, grad_kde, obs_x, obs_y, obs_valid, n_pre,
                  score_thresh, spec: BinSpec, fix_endpoints: bool,
                  kde_thresh: float, pixel_thresh: int, algo_thresh: int,
                  max_decays: int = 400, cand_mask=None) -> Selection:
    """One selection round: scores, adaptive threshold, per-bin NMS.

    Args:
      kde_arr: (M, N) curve KDE of this iteration.
      grad_kde: (M, N) init-time gradient KDE.
      obs_x/obs_y/obs_valid: previous observations, per-bin buffers.
      n_pre: scalar int — number of previous observations
        (``pre_fobs.shape[0]``, gpet.py:561).
      score_thresh: current adaptive threshold (carried across iterations).
      cand_mask: optional (M, N) bool mask overriding the internally
        derived candidate set (the reference's ``pixel_idx`` argument to
        ``compute_new_obs``, gpet.py:532-535; ``None`` = derive from
        ``kde_arr`` as ``get_best_pixels`` does, gpet.py:648-657).
    """
    M, N = kde_arr.shape
    dtype = kde_arr.dtype
    cols = jnp.arange(N, dtype=jnp.int32)

    # --- eligibility -----------------------------------------------------
    dense_cand = kde_arr > kde_thresh                        # gpet.py:651
    if cand_mask is not None:
        cand = cand_mask
    elif fix_endpoints:                                      # gpet.py:655-657
        col_ok = (cols > spec.x_st) & (cols < spec.x_en)
        cand = dense_cand & col_ok[None, :]
    else:
        cand = dense_cand
    # Previous observations: keep if still intersected (gpet.py:571).
    # Dense one-hot matmul instead of a scatter:
    # old_grid = 1[∃k valid: obs_y[k]=m ∧ obs_x[k]=n].
    oy = ((obs_y[None, :] == jnp.arange(M, dtype=jnp.int32)[:, None])
          & obs_valid[None, :]).astype(dtype)             # (M, K)
    ox = (obs_x[None, :]
          == jnp.arange(N, dtype=jnp.int32)[:, None]).astype(dtype)  # (N, K)
    old_grid = jnp.matmul(oy, ox.T,
                          precision=jax.lax.Precision.HIGHEST) > 0.5
    elig = cand | (old_grid & dense_cand)

    # --- dense pixel score (gpet.py:582) ---------------------------------
    score = (kde_arr * grad_kde + kde_arr + grad_kde) / 3.0
    score = jnp.where(elig, score, -jnp.inf)

    bin_of_col = _bin_of_col(spec, N)                        # (N,) static
    bin_onehot = (bin_of_col[None, :]
                  == jnp.arange(spec.n_bins, dtype=jnp.int32)[:, None])

    # --- per-bin max pixel (gpet.py:613-616) -------------------------------
    # The pixel selected for an occupied bin is always that bin's maximum-
    # score eligible pixel (the per-bin argmax over thresholded pixels is
    # the bin max whenever the bin passes), so the argmax is threshold-
    # independent and the adaptive search only decides *occupancy*.
    col_best = jnp.max(score, axis=0)                        # (N,)
    col_best_y = jnp.argmax(score, axis=0).astype(jnp.int32)
    per_bin = jnp.where(bin_onehot, col_best[None, :], -jnp.inf)  # (B, N)
    bin_best_col = jnp.argmax(per_bin, axis=1).astype(jnp.int32)
    bin_best_score = jnp.max(per_bin, axis=1)                # (B,)

    # --- adaptive threshold (gpet.py:589-609), vectorised ------------------
    # The reference decays score_thresh by 0.95 per pass (no decay on the
    # first pass, gpet.py:594-595) until enough bins are occupied. The
    # occupancy count n(j) = #bins with bin_best >= thresh0·0.95^j is
    # monotone in j, so the sequential loop reduces to "first j whose
    # count satisfies the stop condition" — all candidate thresholds are
    # evaluated at once instead of serial while-loop round trips.
    # cumprod mirrors the reference's repeated multiplication bit-for-bit.
    thresh0 = jnp.asarray(score_thresh, dtype)
    n_pre = jnp.asarray(n_pre, jnp.int32)
    decays = jnp.concatenate([jnp.ones((1,), dtype),
                              jnp.full((max_decays - 1,), 0.95, dtype)])
    threshs = thresh0 * jnp.cumprod(decays)                  # (J,)
    n_at = jnp.sum(bin_best_score[None, :] >= threshs[:, None],
                   axis=1, dtype=jnp.int32)                  # (J,)
    stop = (n_at - n_pre >= pixel_thresh) | (n_at >= algo_thresh)
    j = jnp.where(jnp.any(stop), jnp.argmax(stop), max_decays - 1)
    thresh = threshs[j]

    valid = bin_best_score >= thresh
    new_x = jnp.where(valid, bin_best_col, 0)
    new_y = jnp.where(valid, col_best_y[bin_best_col], 0)
    n_fobs = jnp.sum(valid, dtype=jnp.int32)
    return Selection(obs_x=new_x, obs_y=new_y, obs_valid=valid,
                     n_fobs=n_fobs, score_thresh=thresh)
