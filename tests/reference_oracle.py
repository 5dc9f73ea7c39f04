"""NumPy/SciPy oracles re-implementing the reference formulas.

Golden-value generators for the trace-pipeline tests (SURVEY.md §4):
each function re-derives, in plain NumPy, the exact math the reference
performs — KDEpy.FFTKDE's linear-binning + Gaussian-convolution KDE
(gpet.py:514-527), the Simpson curve cost (gpet.py:391-408), and the
pixel scoring / adaptive-threshold / binning selection (gpet.py:532-662)
— so the JAX implementations can be checked against dynamic-shape,
float64 host computations. KDEpy itself is not installed in this image;
linear binning + discrete convolution is the documented FFTKDE algorithm
and is validated here additionally against direct Gaussian summation.
"""

from __future__ import annotations

import numpy as np
import scipy.integrate
import scipy.interpolate
import scipy.signal


# ---------------------------------------------------------------------------
# KDE (gpet.py:455-529)
# ---------------------------------------------------------------------------

def _linear_binning(points_xy, weights, M, N):
    """Bilinear scatter of weighted points onto the padded integer grid
    [-1..N] x [-1..M] (grid shape (M+2, N+2), indexed [y+1, x+1])."""
    grid = np.zeros((M + 2, N + 2))
    gx = np.asarray(points_xy)[:, 0] + 1.0
    gy = np.asarray(points_xy)[:, 1] + 1.0
    x0 = np.floor(gx).astype(int)
    y0 = np.floor(gy).astype(int)
    fx = gx - x0
    fy = gy - y0
    w = np.asarray(weights, dtype=float)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            np.add.at(grid, (y0 + dy, x0 + dx), w * wy * wx)
    return grid


def _gaussian_2d(radius=8, bw=1.0):
    t = np.arange(-radius, radius + 1)
    g = np.exp(-0.5 * (t / bw) ** 2)
    return np.outer(g, g)


def oracle_kde(points_xy, weights, M, N, radius=8, bw=1.0):
    """FFTKDE-equivalent KDE: linear binning, Gaussian convolution on the
    padded grid, crop, min-max normalise (gpet.py:514-527)."""
    pts = np.asarray(points_xy, dtype=float)
    w = np.asarray(weights, dtype=float)
    keep = (pts[:, 1] >= 0) & (pts[:, 1] <= M - 1)  # gpet.py:498-500
    pts, w = pts[keep], w[keep]
    grid = _linear_binning(pts, w, M, N)
    blurred = scipy.signal.fftconvolve(grid, _gaussian_2d(radius, bw),
                                       mode="same")
    kde = blurred[1:-1, 1:-1]
    return (kde - kde.min()) / (kde.max() - kde.min())


def oracle_kde_direct(points_xy, weights, M, N, bw=1.0):
    """Direct (un-binned) Gaussian-sum KDE — cross-check of the binning."""
    ys, xs = np.mgrid[0:M, 0:N]
    pts = np.asarray(points_xy, dtype=float)
    w = np.asarray(weights, dtype=float)
    keep = (pts[:, 1] >= 0) & (pts[:, 1] <= M - 1)
    pts, w = pts[keep], w[keep]
    d2 = ((xs[..., None] - pts[None, None, :, 0]) ** 2
          + (ys[..., None] - pts[None, None, :, 1]) ** 2)
    kde = np.sum(w * np.exp(-0.5 * d2 / bw ** 2), axis=-1)
    return (kde - kde.min()) / (kde.max() - kde.min())


def oracle_gradient_kde(grad_img, kde_thresh=1e-3, radius=8, bw=1.0):
    """Init-time gradient KDE (gpet.py:503-509): integer pixel points with
    intensity weights."""
    pts_yx = np.argwhere(grad_img > kde_thresh)
    w = grad_img[pts_yx[:, 0], pts_yx[:, 1]]
    pts_xy = pts_yx[:, ::-1].astype(float)
    M, N = grad_img.shape
    return oracle_kde(pts_xy, w, M, N, radius=radius, bw=bw)


# ---------------------------------------------------------------------------
# Curve cost (gpet.py:371-410)
# ---------------------------------------------------------------------------

def oracle_cost(grad_img, x, y, kde_thresh=1e-3):
    """Arc-length / line-integral cost of the curve (x, y)."""
    M, N = grad_img.shape
    interp = scipy.interpolate.RectBivariateSpline(
        np.arange(M), np.arange(N), grad_img, kx=1, ky=1)
    order = np.argsort(x)
    x, y = np.asarray(x, float)[order], np.asarray(y, float)[order]
    grad_score = interp(y, x, grid=False) + kde_thresh
    steps = np.sqrt(np.diff(x) ** 2 + np.diff(y) ** 2)
    curvilinear = np.cumsum(steps)
    integrand = np.sqrt(1.0 + np.diff(y) ** 2)
    line_integral = scipy.integrate.simpson(grad_score[:-1], x=curvilinear)
    arc_length = scipy.integrate.simpson(integrand, x=x[:-1])
    return arc_length / line_integral


# ---------------------------------------------------------------------------
# Pixel selection (gpet.py:532-662)
# ---------------------------------------------------------------------------

def oracle_select(kde_arr, grad_kde, pre_fobs_xy, score_thresh, x_st, x_en,
                  delta_x, pixel_thresh, algo_thresh, fix_endpoints,
                  kde_thresh=1e-3):
    """get_best_pixels + compute_new_obs, dynamic-shape reference semantics.

    ``pre_fobs_xy``: (P, 2) xy-space previous observations. Returns
    ``(fobs_xy (K, 2), new_score_thresh)``.
    """
    cand_yx = np.argwhere(kde_arr > kde_thresh)
    if fix_endpoints:
        keep = (cand_yx[:, 1] > x_st) & (cand_yx[:, 1] < x_en)
        cand_yx = cand_yx[keep]

    pre_yx = np.asarray(pre_fobs_xy, int).reshape(-1, 2)[:, ::-1]
    n_pre = pre_yx.shape[0]

    old_int = kde_arr[pre_yx[:, 0], pre_yx[:, 1]]
    keep_old = old_int > kde_thresh
    old_yx = pre_yx[keep_old]
    old_int = old_int[keep_old]
    old_grad = grad_kde[old_yx[:, 0], old_yx[:, 1]]

    new_int = kde_arr[cand_yx[:, 0], cand_yx[:, 1]]
    new_grad = grad_kde[cand_yx[:, 0], cand_yx[:, 1]]

    pixels = np.concatenate([old_yx, cand_yx], axis=0)
    ivals = np.concatenate([old_int, new_int])
    gvals = np.concatenate([old_grad, new_grad])
    scores = (ivals * gvals + ivals + gvals) / 3.0

    n_pix = n_pre
    i = 0
    thresh = float(score_thresh)
    # One unconditional pass so best/bins/uniq are defined even when the
    # decay loop never runs (upstream latent NameError).
    mask = scores >= thresh
    best = pixels[mask]
    best_scores = scores[mask]
    bins = np.round((best[:, 1] - x_st) / delta_x).astype(int)
    uniq = np.unique(bins)
    while (n_pix - n_pre < pixel_thresh) and (n_pix < algo_thresh):
        if i > 0:
            thresh *= 0.95
        mask = scores >= thresh
        best = pixels[mask]
        best_scores = scores[mask]
        bins = np.round((best[:, 1] - x_st) / delta_x).astype(int)
        uniq = np.unique(bins)
        n_pix = uniq.shape[0]
        i += 1
        if i > 500:
            break

    fobs = np.zeros((n_pix, 2), dtype=int)
    for k, b in enumerate(uniq):
        sel = bins == b
        j = np.argmax(best_scores[sel])
        fobs[k] = best[sel][j][::-1]  # yx -> xy
    return fobs, thresh
