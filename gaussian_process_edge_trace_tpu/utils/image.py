"""Image preprocessing ops (pure JAX).

Covers the reference's ``gpet_utils`` preprocessing surface
(reference: gp_edge_tracing/gpet_utils.py:10-158):

- :func:`kernel_builder`  — extended-Sobel derivative filter (gpet_utils.py:10-61)
- :func:`normalise`       — min-max rescale (gpet_utils.py:65-91)
- :func:`comp_grad_img`   — gradient image via convolution (gpet_utils.py:95-119)
- :func:`denoise`         — denoising dispatch (gpet_utils.py:122-158)

All functions accept numpy or JAX arrays and return JAX arrays; they are
jit-compatible (no data-dependent shapes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def kernel_builder(size, b2d=False, normalize=False, vertical_edges=False, unit=False):
    """Build an extended-Sobel edge-detection kernel.

    Matches the reference construction (gpet_utils.py:10-61): the top
    ``N//2`` rows hold ``1 + max(0, mid_r + 1 - |i-mid_r| - |j-mid_c|)``
    pyramid weights (or all ones if ``unit``), the bottom rows are the
    negated vertical flip, the middle row is zero.

    This is a host-side pure function of static shape arguments; it returns
    a numpy array so it can be used for both oracle tests and as a static
    convolution filter.
    """
    N, M = size
    kernel = np.zeros((N, M), dtype=np.float64)
    mid_r = N // 2
    mid_c = M // 2

    if unit:
        kernel[:mid_r, :] = 1.0
    else:
        i = np.arange(mid_r)[:, None]
        j = np.arange(M)[None, :]
        weight = np.maximum(0, mid_r + 1 - np.abs(i - mid_r) - np.abs(j - mid_c))
        kernel[:mid_r, :] = 1.0 + weight

    # Bottom half = negated vertical flip of top half (middle row stays 0).
    # For even N the reference assignment raises a shape error; kernels are
    # expected to have odd height.
    kernel[mid_r + 1:, :] = -np.flip(kernel[0:mid_r, :], axis=0)

    if b2d:
        kernel = np.flipud(kernel)
    if vertical_edges:
        kernel = kernel.T
    if normalize:
        kernel = kernel / kernel.max()
    return kernel


def normalise(img, minmax_val=(0, 1), astyp=jnp.float32):
    """Min-max rescale ``img`` into ``[min_val, max_val]``.

    Matches gpet_utils.py:65-91 (compute in float32, rescale, cast).
    """
    min_val, max_val = minmax_val
    img = jnp.asarray(img, dtype=jnp.float32)
    img = img - jnp.min(img)
    img = img / jnp.max(img)
    img = img * (max_val - min_val) + min_val
    if astyp in (np.float64, jnp.float64, float):
        # The device path stays float32; float64 only materialises under
        # x64 mode.
        astyp = jnp.result_type(jnp.float64)
    return img.astype(astyp)


@functools.partial(jax.jit, static_argnames=("kernel", "norm"))
def _conv_nearest(img, kernel, norm=True):
    """Correlate ``img`` with ``kernel`` using edge-replicate padding.

    Equivalent to ``scipy.ndimage.convolve(img, kernel, mode='nearest')``:
    scipy *convolves* (flips the kernel) while XLA correlates, so we flip
    the kernel here. ``kernel`` is a static (hashable) nested tuple of
    taps — derivative filters are small host-built constants.
    """
    img = jnp.asarray(img, dtype=jnp.float32)
    kernel = np.asarray(kernel, dtype=np.float64)
    kh, kw = kernel.shape
    # scipy.ndimage.convolve centers the *flipped* kernel with origin at
    # floor(k/2) measured after the flip; for odd sizes this is symmetric.
    # Padding amounts for even sizes follow scipy: left pad = k//2 of the
    # flipped (correlation) window.
    flip = kernel[::-1, ::-1]
    ph_lo, ph_hi = kh // 2, (kh - 1) // 2
    pw_lo, pw_hi = kw // 2, (kw - 1) // 2
    padded = jnp.pad(img, ((ph_lo, ph_hi), (pw_lo, pw_hi)), mode="edge")
    # Shifted multiply-accumulate: kh·kw shifted elementwise FMAs that XLA
    # fuses into one pass (a single-channel spatial convolution has no
    # channel dimension to feed a matrix unit). Taps are static Python
    # floats, so zero taps vanish at trace time.
    H, W = img.shape
    taps = flip
    out = jnp.zeros_like(img)
    for dy in range(kh):
        for dx in range(kw):
            t = float(taps[dy, dx])
            if t == 0.0:
                continue
            out = out + t * jax.lax.dynamic_slice(padded, (dy, dx), (H, W))
    out = jnp.maximum(out, 0.0)
    if norm:
        out = normalise(out, (0, 1), jnp.float32)
    else:
        out = out.astype(jnp.int32)
    return out


def comp_grad_img(img, kernel, norm=True, astyp=jnp.float32):
    """Gradient image: convolve, clamp negatives to zero, normalise.

    Reference: gpet_utils.py:95-119. The reference has a latent bug — its
    ``if normalise:`` tests the imported *function* (always truthy), so
    ``norm=False`` is silently ignored. We honour ``norm`` (SURVEY.md C17:
    fix the flag bug; the default path is identical).
    """
    # No np.asarray on the image: a device->host conversion would force a
    # round trip (and keep the input off-device). The kernel is a
    # small host constant, passed statically as a nested tuple.
    k = np.asarray(kernel, dtype=np.float64)
    k_static = tuple(tuple(float(v) for v in row) for row in k)
    out = _conv_nearest(img, k_static, norm=bool(norm))
    if norm:
        out = out.astype(astyp if astyp not in (np.float64, float) else jnp.result_type(jnp.float64))
    return out


def _gaussian_filter_1d(size_sigma):
    sigma, radius = size_sigma
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def denoise(image, technique, kwargs, plot=False, verbose=False):
    """Denoise ``image``; dispatch over techniques (gpet_utils.py:122-158).

    All seven of the reference's techniques run natively on device:
    ``gaussian``/``median``/``minimum`` (separable conv / reduce-window),
    ``tvc`` (Chambolle projection), ``nl`` (non-local means via shifted
    box sums), ``wavelet`` (Haar DWT + BayesShrink/VisuShrink), and
    ``tvb`` (split-Bregman TV) — scikit-image is not required (PARITY.md
    documents the in-kind equivalences for wavelet/tvb).

    Caveat (in-kind, not bit-faithful): ``wavelet`` honours
    ``wavelet=`` for the Daubechies family ``db1``–``db16`` and the
    symlet (least-asymmetric) family ``sym2``–``sym16`` (real filter
    pairs + QMF, generated by spectral factorization —
    ``denoise_native._daubechies``/``_symlet``) with pywt-style
    symmetric boundary extension (r5), and raises
    ``NotImplementedError`` for any other pywt name rather than silently
    substituting (PARITY.md C18). ``tvb`` minimises the same
    split-Bregman objective with a damped-Jacobi inner solve, so
    per-pixel values differ from skimage's Gauss-Seidel at equal
    ``max_num_iter`` (gpet_utils.py:134-140).
    """
    image = jnp.asarray(image, dtype=jnp.float32)
    out = _denoise_dispatch(image, technique, kwargs)
    if verbose and out is not None:   # quality report, gpet_utils.py:151-156
        from gaussian_process_edge_trace_tpu.utils.denoise_native import (
            normalized_root_mse, peak_signal_noise_ratio, shannon_entropy,
            structural_similarity)
        psnr = round(float(peak_signal_noise_ratio(image, out)), 2)
        ss = round(float(structural_similarity(image, out)), 2)
        nmse = round(float(normalized_root_mse(image, out)), 5)
        ent = round(float(shannon_entropy(out)), 3)
        print(f"Peak-SNR: {psnr}.\nStructural Similarity: {ss}.\n"
              f"Mean Square Error: {nmse}.\nShannon Entropy: {ent}.\n")
    return out


# scipy.ndimage boundary modes -> jnp.pad modes (scipy default 'reflect'
# mirrors without repeating the edge sample == numpy 'symmetric').
_PAD_MODES = {"reflect": "symmetric", "nearest": "edge", "mirror": "reflect",
              "wrap": "wrap", "constant": "constant"}


def _denoise_dispatch(image, technique, kwargs):
    if technique in ("gaussian", "median", "minimum"):
        # scipy.ndimage filters interpret 'mode' as a boundary mode; for
        # 'wavelet' it is the soft/hard thresholding switch instead.
        pad_mode = _PAD_MODES[kwargs.get("mode", "reflect")]
    if technique == "gaussian":
        sigma = float(kwargs.get("sigma", 1.0))
        radius = int(kwargs.get("radius", int(4.0 * sigma + 0.5)))
        k = jnp.asarray(_gaussian_filter_1d((sigma, radius)), dtype=jnp.float32)
        pad = ((radius, radius), (0, 0))
        out = jnp.pad(image, pad, mode=pad_mode)
        out = jax.lax.conv_general_dilated(
            out[None, None], k[None, None, :, None], (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"))[0, 0]
        out = jnp.pad(out, ((0, 0), (radius, radius)), mode=pad_mode)
        out = jax.lax.conv_general_dilated(
            out[None, None], k[None, None, None, :], (1, 1), "VALID",
            dimension_numbers=("NCHW", "OIHW", "NCHW"))[0, 0]
        return out
    elif technique in ("median", "minimum"):
        size = int(kwargs.get("size", 3))
        pad = size // 2
        padded = jnp.pad(image, pad, mode=pad_mode)
        if technique == "minimum":
            return -jax.lax.reduce_window(
                -padded, -jnp.inf, jax.lax.max, (size, size), (1, 1), "VALID")
        # Median via sorting the unfolded window (size is small and static).
        patches = []
        for dy in range(size):
            for dx in range(size):
                patches.append(
                    jax.lax.dynamic_slice(padded, (dy, dx), image.shape))
        stack = jnp.stack(patches, axis=-1)
        return jnp.median(stack, axis=-1)
    elif technique == "tvc":
        from gaussian_process_edge_trace_tpu.utils.denoise_native import (
            denoise_tv_chambolle)
        kwargs = {k: v for k, v in kwargs.items() if k != "mode"}
        return denoise_tv_chambolle(image, **kwargs)
    elif technique == "nl":
        from gaussian_process_edge_trace_tpu.utils.denoise_native import (
            denoise_nl_means)
        return denoise_nl_means(image, **kwargs)
    elif technique == "wavelet":
        from gaussian_process_edge_trace_tpu.utils.denoise_native import (
            denoise_wavelet)
        return denoise_wavelet(image, **kwargs)
    elif technique == "tvb":
        from gaussian_process_edge_trace_tpu.utils.denoise_native import (
            denoise_tv_bregman)
        return denoise_tv_bregman(image, **kwargs)
    else:
        print("Denoising technique not implemented.")
        return None
