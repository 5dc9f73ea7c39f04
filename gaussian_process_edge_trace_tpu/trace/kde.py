"""Dual-mode kernel-density estimate on the pixel grid.

JAX replacement for ``KDEpy.FFTKDE(kernel='gaussian', bw=1)``
(reference: gpet.py:455-529). FFTKDE's algorithm is *linear binning* of the
weighted sample points onto the evaluation grid followed by convolution
with the Gaussian kernel sampled on that grid. We reproduce exactly that
discretisation — without the FFT, since the kernel support is tiny (the
Gaussian at bw=1 is < 1e-14 of its peak beyond 8 px) and XLA convolutions
of small separable filters are faster than FFTs at these sizes.

Grid semantics follow the reference exactly (gpet.py:515-527): the KDE is
evaluated on the integer grid ``[-1, N] x [-1, M]`` (one-pixel pad on every
side), cropped back to ``(M, N)``, then min-max normalised to [0, 1]. The
min-max normalisation makes every global scale factor (KDEpy's density
normalisation) irrelevant, so only the *shape* must match — which binning +
discrete convolution gives bit-consistently.

Two modes:

- :func:`curve_kde` — posterior-curve mode (gpet.py:485-500): sample points
  are the best-curve pixels, each weighted by the normalised inverse cost
  of its curve; points with y outside [0, M-1] are dropped (weight 0 here —
  deletion and zero-weighting are identical under linear binning).
  Curve x-coordinates are exactly the integer grid columns, so binning in x
  is exact and the 2-D linear binning reduces to a per-column 1-D binning —
  a dense hat-function contraction that XLA executes as one fused reduce.
- :func:`gradient_kde` — image-gradient mode (gpet.py:503-509): sample
  points are the integer pixels with gradient above ``kde_thresh``,
  weighted by their intensity; integer points bin to a single node, so
  binning is just a masked copy of the gradient image.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Gaussian truncation radius, in pixels (bw = 1). exp(-0.5 * 8^2) ~ 1.3e-14
# relative to the peak: far below every threshold in the pipeline, so the
# truncated convolution is numerically identical to KDEpy's full FFT.
DEFAULT_RADIUS = 8


def gaussian_taps(radius: int, bw: float = 1.0, dtype=jnp.float32):
    """Discrete Gaussian samples exp(-t^2 / (2 bw^2)) on [-radius, radius].

    Unnormalised — the reference min-max normalises the KDE (gpet.py:527)
    so constant factors cancel.
    """
    t = jnp.arange(-radius, radius + 1, dtype=dtype)
    return jnp.exp(-0.5 * (t / bw) ** 2)


def _toeplitz(n, taps, dtype):
    """Banded Toeplitz blur matrix T with T[i, j] = taps[i - j + radius]."""
    r = (taps.shape[0] - 1) // 2
    idx = jnp.arange(n)
    d = idx[:, None] - idx[None, :]
    return jnp.where(jnp.abs(d) <= r, taps[jnp.clip(d + r, 0, 2 * r)],
                     0.0).astype(dtype)


# Above this edge length the dense Toeplitz blur matmul's O(n³) loses to
# the O(n²·taps) shifted-FMA pass. Gated PER AXIS: the axis-0 blur
# contracts over m (cost m²·n matmul vs m·n·taps FMA) independently of n,
# so a 512×1536 image blurs axis 0 as a matmul and axis 1 as FMAs. The
# crossover was tuned on the previous accelerator and is not yet swept on
# the H100 (ROADMAP C5).
_BLUR_MATMUL_MAX = 600


def _blur_axis_fma(grid, taps, axis):
    """1-D zero-boundary convolution along ``axis`` as static-tap shifted
    FMAs (the ``comp_grad_img`` pattern, utils/image.py): pad, take the
    2r+1 statically-offset slices, accumulate elementwise."""
    r = (taps.shape[0] - 1) // 2
    n = grid.shape[axis]
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    g = jnp.pad(grid, pad)
    out = taps[0] * jax.lax.slice_in_dim(g, 0, n, axis=axis)
    for k in range(1, int(taps.shape[0])):
        out = out + taps[k] * jax.lax.slice_in_dim(g, k, k + n, axis=axis)
    return out


def _separable_blur(grid, taps, mats=None):
    """2-D convolution with the separable kernel ``taps ⊗ taps``.

    Zero ('SAME') boundary — FFTKDE's linear convolution sees zeros beyond
    the evaluation grid too. Two forms, size-gated per axis
    (``_BLUR_MATMUL_MAX``): banded-Toeplitz matmuls at demo scale, while
    a long axis blurs faster as a shifted-FMA pass. ``mats`` are precomputed
    ``blur_matrices`` — pass them inside loops (see there); a ``None``
    entry means "that axis runs as FMAs".
    """
    m, n = grid.shape
    if mats is None:
        mats = (_toeplitz(m, taps, grid.dtype)
                if m <= _BLUR_MATMUL_MAX else None,
                _toeplitz(n, taps, grid.dtype)
                if n <= _BLUR_MATMUL_MAX else None)
    Ty, Tx = mats
    out = (jnp.matmul(Ty, grid, precision=jax.lax.Precision.HIGHEST)
           if Ty is not None else _blur_axis_fma(grid, taps, axis=0))
    return (jnp.matmul(out, Tx, precision=jax.lax.Precision.HIGHEST)
            if Tx is not None else _blur_axis_fma(out, taps, axis=1))


def blur_matrices(M: int, N: int, dtype=jnp.float32,
                  radius: int = DEFAULT_RADIUS, bw: float = 1.0):
    """Loop-invariant blur Toeplitz factors (Ty, Tx) for the padded
    (M+2, N+2) KDE grid.

    Identical ops to the inline build, so the blur output is bitwise
    unchanged — but computed ONCE before a ``lax.while_loop`` and passed
    down as ``blur=``: XLA neither constant-folds the (n, n) build (the
    literal exceeds its folding size cap) nor hoists it out of the loop
    body (it fuses with loop-dependent consumers), so the inline form
    re-ran every iteration.
    Per-axis gate: each factor is ``None`` when its axis exceeds
    ``_BLUR_MATMUL_MAX`` (that axis runs as shifted FMAs and needs no
    matrix); ``None`` overall when both do.
    """
    if min(M, N) + 2 > _BLUR_MATMUL_MAX:
        return None
    taps = gaussian_taps(radius, bw, dtype)
    return (_toeplitz(M + 2, taps, dtype).astype(dtype)
            if M + 2 <= _BLUR_MATMUL_MAX else None,
            _toeplitz(N + 2, taps, dtype).astype(dtype)
            if N + 2 <= _BLUR_MATMUL_MAX else None)


def _minmax(grid):
    lo = jnp.min(grid)
    hi = jnp.max(grid)
    return (grid - lo) / (hi - lo)


# Target size for one hat-contraction block: (M+2)·E·chunk elements.
# Larger sample counts (BASELINE config 4, N_samples → 10⁵) are scanned
# in chunks of this size instead of materialising a multi-GB tensor; the
# demo shapes (25M elements) stay a single unchunked block. The value was
# tuned on the previous accelerator and is not yet swept on the H100
# (ROADMAP C5).
_CHUNK_ELEMS = 128 * 1024 * 1024


def column_binning(y_curves, weights, M: int):
    """Binned column masses H (M+2, E) for the curve KDE: per-column linear
    binning as a dense hat-function contraction over the samples,

        H[m, e] = Σ_s w[e, s] · max(0, 1 − |(y[e, s] + 1) − m|),

    with the out-of-image deletion rule (weight 0 for y outside
    [0, M-1], gpet.py:498-500) folded into the weights. Sample counts
    whose (M+2, E, S) hat tensor exceeds ``_CHUNK_ELEMS`` are scanned in
    chunks (padded samples carry zero weight)."""
    E, S = y_curves.shape
    dtype = y_curves.dtype
    rows = jnp.arange(M + 2, dtype=dtype)

    def block(yb, wb):
        yp = yb + 1.0
        w = jnp.broadcast_to(wb[None, :], yb.shape)
        w = jnp.where((yb >= 0) & (yb <= M - 1), w, 0.0)
        hat = jnp.maximum(0.0, 1.0 - jnp.abs(yp[None, :, :]
                                             - rows[:, None, None]))
        return jnp.sum(hat * w[None, :, :], axis=-1)      # (M+2, E)

    chunk = max(1, _CHUNK_ELEMS // ((M + 2) * E))
    if S <= chunk:
        return block(y_curves, weights)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    yb = jnp.pad(y_curves, ((0, 0), (0, pad)))
    wb = jnp.pad(weights, (0, pad))
    yb = yb.reshape(E, n_chunks, chunk)
    wb = wb.reshape(n_chunks, chunk)

    def body(carry, inp):
        yc, wc = inp
        return carry + block(yc, wc), None

    # Seed the scan carry from the FIRST chunk instead of jnp.zeros: under
    # shard_map (check_vma=True) a literal-zeros carry is sample-invariant
    # typed while the chunk contributions are varying-typed, which rejects
    # the scan on any mesh. Identical f32 arithmetic: 0 + block == block.
    ycs = jnp.moveaxis(yb, 1, 0)
    H0 = block(ycs[0], wb[0])
    H, _ = jax.lax.scan(body, H0, (ycs[1:], wb[1:]))
    return H


def curve_kde_raw(y_curves, weights, M: int, N: int, x_start: int,
                  radius: int = DEFAULT_RADIUS, bw: float = 1.0, blur=None):
    """Un-normalised curve KDE (binning + blur + crop, no min-max).

    The building block for sample-axis sharding: the blurred grid is
    additive over curves, so per-device partial grids can be ``psum``-med
    over the sample mesh axis before the global min-max normalisation.
    """
    dtype = y_curves.dtype
    H = column_binning(y_curves, weights, M)               # (M+2, E)

    # Place the E columns at padded-grid columns x_start+1 .. x_start+E.
    grid = jnp.zeros((M + 2, N + 2), dtype=dtype)
    grid = jax.lax.dynamic_update_slice(grid, H, (0, x_start + 1))

    taps = gaussian_taps(radius, bw, dtype)
    blurred = _separable_blur(grid, taps, mats=blur)
    return blurred[1:-1, 1:-1]


@functools.partial(jax.jit, static_argnames=("M", "N", "x_start", "radius"))
def curve_kde(y_curves, weights, M: int, N: int, x_start: int,
              radius: int = DEFAULT_RADIUS, bw: float = 1.0, blur=None):
    """KDE of the best posterior curves on the (M, N) pixel grid.

    Args:
      y_curves: (E, S) y-values of the S best curves at the E grid columns
        ``x_start .. x_start+E-1``.
      weights: (S,) per-curve weights (normalised inverse costs,
        gpet.py:492-493 — normalisation is irrelevant under min-max).
      M, N: image shape. x_start: first grid column.
      blur: optional precomputed :func:`blur_matrices` (pass inside
        loops; bitwise-identical output either way).

    Returns:
      (M, N) KDE, min-max normalised to [0, 1].
    """
    return _minmax(curve_kde_raw(y_curves, weights, M, N, x_start,
                                 radius, bw, blur=blur))


def kde_normalise(raw):
    """Min-max normalise a (psum-reduced) raw KDE grid (gpet.py:527)."""
    return _minmax(raw)


@functools.partial(jax.jit, static_argnames=("radius",))
def gradient_kde(grad_img, kde_thresh: float = 1e-3,
                 radius: int = DEFAULT_RADIUS, bw: float = 1.0):
    """KDE of the gradient image (init-time mode, gpet.py:503-509).

    Sample points are the integer pixels with ``grad > kde_thresh``,
    weighted by intensity; binning of integer points is a masked copy.
    """
    M, N = grad_img.shape
    masked = jnp.where(grad_img > kde_thresh, grad_img, 0.0)
    grid = jnp.pad(masked, 1)
    taps = gaussian_taps(radius, bw, grad_img.dtype)
    blurred = _separable_blur(grid, taps)
    return _minmax(blurred[1:-1, 1:-1])
