"""JAX-native denoisers and image-quality metrics (reference C18,
gpet_utils.py:122-158).

The reference dispatches to scikit-image/scipy denoisers and quality
metrics. This module provides device-native implementations so the
``denoise`` surface works without scikit-image:

- :func:`denoise_tv_chambolle` — Chambolle's projection algorithm for the
  ROF total-variation model (the ``tvc`` technique), a fixed-iteration
  ``lax.fori_loop`` of forward-difference/divergence updates;
- :func:`denoise_nl_means` — non-local means on a dense window of patch
  offsets (patch L2 distances via shifted box sums — convolution-style
  shifted FMAs, no gathers);
- quality metrics matching skimage semantics for the reference's verbose
  report (gpet_utils.py:151-156): :func:`peak_signal_noise_ratio`,
  :func:`normalized_root_mse` (min-max), :func:`structural_similarity`
  (uniform 7×7 filter, skimage defaults), :func:`shannon_entropy`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("n_iter",))
def denoise_tv_chambolle(image, weight=0.1, n_iter=100):
    """Chambolle 2004 dual projection for the ROF model.

    Matches ``skimage.restoration.denoise_tv_chambolle`` semantics (same
    dual update with step 1/4 in 2-D and the same weight convention) with
    a fixed iteration count instead of an eps-based stop.
    """
    img = jnp.asarray(image, jnp.float32)
    tau = 0.25
    w = jnp.asarray(weight, jnp.float32)

    def grad(u):
        gy = jnp.concatenate([u[1:] - u[:-1], jnp.zeros_like(u[:1])], 0)
        gx = jnp.concatenate([u[:, 1:] - u[:, :-1],
                              jnp.zeros_like(u[:, :1])], 1)
        return gy, gx

    def div(py, px):
        dy = jnp.concatenate([py[:1], py[1:-1] - py[:-2], -py[-2:-1]], 0)
        dx = jnp.concatenate([px[:, :1], px[:, 1:-1] - px[:, :-2],
                              -px[:, -2:-1]], 1)
        return dy + dx

    def body(_, p):
        # Chambolle 2004: p ← (p − (τ/λ)∇u) / (1 + (τ/λ)|∇u|) with
        # u = f − λ·div p (∇(div p − f/λ) = −∇u/λ).
        py, px = p
        u = img - w * div(py, px)
        gy, gx = grad(u)
        norm = jnp.sqrt(gy * gy + gx * gx)
        denom = 1.0 + (tau / w) * norm
        py = (py - (tau / w) * gy) / denom
        px = (px - (tau / w) * gx) / denom
        return (py, px)

    p0 = (jnp.zeros_like(img), jnp.zeros_like(img))
    py, px = jax.lax.fori_loop(0, n_iter, body, p0)
    return img - w * div(py, px)


@functools.partial(jax.jit,
                   static_argnames=("patch_size", "patch_distance"))
def denoise_nl_means(image, patch_size=7, patch_distance=11, h=0.1,
                     sigma=0.0):
    """Non-local means over a dense offset window.

    For every offset d in the (2·patch_distance+1)² search window, the
    per-pixel patch distance is a box filter of the shifted squared
    difference — shifted FMAs and separable box sums only (no
    gathers). Weights follow skimage's fast NL-means convention:
    ``exp(-max(dist² - 2σ², 0) / h²)``.
    """
    img = jnp.asarray(image, jnp.float32)
    H, W = img.shape
    pr = patch_size // 2
    pad = patch_distance + pr
    padded = jnp.pad(img, pad, mode="reflect")

    def box2d(a):
        # Separable box filter via cumulative sums (valid region crop).
        k = patch_size
        c = jnp.cumsum(jnp.pad(a, ((1, 0), (0, 0))), axis=0)
        a = (c[k:] - c[:-k])
        c = jnp.cumsum(jnp.pad(a, ((0, 0), (1, 0))), axis=1)
        a = (c[:, k:] - c[:, :-k])
        return a / (k * k)

    num = jnp.zeros((H, W), jnp.float32)
    den = jnp.zeros((H, W), jnp.float32)
    centre = padded[pad - pr:pad + H + pr, pad - pr:pad + W + pr]
    for dy in range(-patch_distance, patch_distance + 1):
        for dx in range(-patch_distance, patch_distance + 1):
            shifted = jax.lax.dynamic_slice(
                padded, (pad + dy - pr, pad + dx - pr),
                (H + 2 * pr, W + 2 * pr))
            d2 = box2d((centre - shifted) ** 2)          # (H, W)
            wgt = jnp.exp(-jnp.maximum(d2 - 2.0 * sigma * sigma, 0.0)
                          / (h * h))
            val = jax.lax.dynamic_slice(padded, (pad + dy, pad + dx),
                                        (H, W))
            num = num + wgt * val
            den = den + wgt
    return num / den


def peak_signal_noise_ratio(image_true, image_test, data_range=None):
    """skimage.metrics.peak_signal_noise_ratio."""
    a = jnp.asarray(image_true, jnp.float64)
    b = jnp.asarray(image_test, jnp.float64)
    if data_range is None:
        data_range = jnp.max(a) - jnp.min(a)
    mse = jnp.mean((a - b) ** 2)
    return 10.0 * jnp.log10((data_range ** 2) / mse)


def normalized_root_mse(image_true, image_test, normalization="min-max"):
    """skimage.metrics.normalized_root_mse (min-max / euclidean / mean)."""
    a = jnp.asarray(image_true, jnp.float64)
    b = jnp.asarray(image_test, jnp.float64)
    rmse = jnp.sqrt(jnp.mean((a - b) ** 2))
    if normalization == "min-max":
        return rmse / (jnp.max(a) - jnp.min(a))
    if normalization == "euclidean":
        return rmse / jnp.sqrt(jnp.mean(a * a))
    return rmse / jnp.mean(a)


def structural_similarity(im1, im2, data_range=None, win_size=7):
    """skimage.metrics.structural_similarity with the default uniform
    filter (gaussian_weights=False), K1=0.01, K2=0.03."""
    a = jnp.asarray(im1, jnp.float64)
    b = jnp.asarray(im2, jnp.float64)
    if data_range is None:
        data_range = jnp.max(a) - jnp.min(a)
    k = win_size

    def ufilt(x):
        c = jnp.cumsum(jnp.pad(x, ((1, 0), (0, 0))), axis=0)
        x = c[k:] - c[:-k]
        c = jnp.cumsum(jnp.pad(x, ((0, 0), (1, 0))), axis=1)
        return (c[:, k:] - c[:, :-k]) / (k * k)

    ua, ub = ufilt(a), ufilt(b)
    n = k * k
    cov_norm = n / (n - 1)
    vara = cov_norm * (ufilt(a * a) - ua * ua)
    varb = cov_norm * (ufilt(b * b) - ub * ub)
    covab = cov_norm * (ufilt(a * b) - ua * ub)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    ssim_map = ((2 * ua * ub + C1) * (2 * covab + C2)) / (
        (ua * ua + ub * ub + C1) * (vara + varb + C2))
    return jnp.mean(ssim_map)


def shannon_entropy(image, base=2):
    """skimage.measure.shannon_entropy (histogram over unique values is
    approximated with a 256-bin histogram of the normalised image)."""
    img = jnp.asarray(image, jnp.float64).ravel()
    lo, hi = jnp.min(img), jnp.max(img)
    hist = jnp.histogram(img, bins=256, range=(float(lo), float(hi)))[0]
    p = hist / jnp.sum(hist)
    p = jnp.where(p > 0, p, 1.0)
    return -jnp.sum(p * jnp.log(p)) / jnp.log(base)


# ---------------------------------------------------------------------------
# Wavelet denoising (the reference's 'wavelet' technique,
# gpet_utils.py:134-140 -> skimage.restoration.denoise_wavelet, which
# forwards the user's ``wavelet=`` kwarg to pywt). Native multi-level
# 2-D DWT for the Daubechies family db1..db16 (db5+ generated by
# spectral factorization, _daubechies) and the symlet family
# sym2..sym16 (least-asymmetric factorization, _symlet) with
# BayesShrink/VisuShrink soft/hard thresholding and the standard MAD
# noise estimate.
# Boundary handling: pywt-style SYMMETRIC
# half-sample extension with the expansive coefficient layout — the same
# boundary semantics the reference inherits through skimage → pywt
# (gpet_utils.py:134-140); the earlier edge-pad + periodic-wrap policy
# differed on the L-2 border pixels per level. Exact perfect
# reconstruction is pinned across db1-db8 × odd/even sizes; BIT parity
# with pywt is still not claimed (pywt/scikit-image are not installed
# here to compare against, PARITY.md). Unsupported wavelet names raise
# NotImplementedError rather than silently substituting.
# ---------------------------------------------------------------------------

_SQRT2 = 2.0 ** 0.5

# Daubechies orthonormal scaling filters (natural order; pywt rec_lo).
# Each satisfies sum h = sqrt(2), ||h|| = 1, and double-shift
# orthogonality — asserted in tests/test_denoise_and_diff.py.
_DB_FILTERS = {
    "db1": np.array([0.7071067811865476, 0.7071067811865476]),
    "haar": np.array([0.7071067811865476, 0.7071067811865476]),
    "db2": np.array([0.48296291314469025, 0.8365163037378079,
                     0.22414386804185735, -0.12940952255092145]),
    "db3": np.array([0.3326705529509569, 0.8068915093133388,
                     0.4598775021193313, -0.13501102001039084,
                     -0.08544127388224149, 0.035226291882100656]),
    "db4": np.array([0.23037781330885523, 0.7148465705525415,
                     0.6308807679295904, -0.02798376941698385,
                     -0.18703481171888114, 0.030841381835986965,
                     0.032883011666982945, -0.010597401784997278]),
}


def _halfband_roots(N: int):
    """Roots of the Daubechies maxflat half-band autocorrelation
    ``P(y) = Σ_{i<N} C(N−1+i, i) y^i`` with ``y = (2 − z − z⁻¹)/4``,
    Newton-polished. Shared by the db (minimum-phase) and sym
    (least-asymmetric) spectral factorizations; the roots come in
    reciprocal-conjugate sets {z, z̄, 1/z, 1/z̄}."""
    from math import comb

    base = np.array([-0.25, 0.5, -0.25])        # y(z) Laurent coefficients
    terms, cur = [], np.array([1.0])
    for i in range(N):
        terms.append(comb(N - 1 + i, i) * cur)
        cur = np.convolve(cur, base)
    width = max(len(t) for t in terms)
    total = np.zeros(width)
    for t in terms:
        pad = (width - len(t)) // 2
        total[pad:pad + len(t)] += t
    p = total[::-1]                              # ordinary poly, z^{2N-2}..z^0
    roots = np.roots(p)
    dp = np.polyder(p)
    for _ in range(3):                           # Newton polish
        roots = roots - np.polyval(p, roots) / np.polyval(dp, roots)
    return roots


def _rebuild_filter(N: int, chosen_roots):
    """``h = √2 · ((1+z)/2)^N · Q(z)/Q(1)`` from a spectral-factor root
    selection (one root per reciprocal pair; conjugate-closed)."""
    q = np.real(np.poly(chosen_roots))           # conjugate pairs → real
    h = np.array([1.0])
    for _ in range(N):
        h = np.convolve(h, [0.5, 0.5])
    h = np.convolve(h, q)
    return h * (_SQRT2 / h.sum())


@functools.lru_cache(maxsize=None)
def _daubechies(N: int):
    """Daubechies-N orthonormal scaling filter (length 2N) by spectral
    factorization: the maxflat half-band roots (:func:`_halfband_roots`),
    keeping the N−1 roots inside the unit circle (minimum phase — pywt's
    convention), rebuild ``Q(z)`` and
    ``h = √2 · ((1+z)/2)^N · Q(z)/Q(1)``. Reproduces the pinned db1–db4
    tables to ≤ 5e-12 and holds double-shift orthonormality to ≤ 1e-8
    through db16 (measured; the monomial-basis root-finding conditions
    worsen with N — beyond 16 the error crosses f32 resolution, so
    :func:`_wavelet_filter` refuses rather than returning a filter worse
    than the transform's own arithmetic). Host NumPy, cached per N."""
    if N == 1:
        return np.array([_SQRT2 / 2, _SQRT2 / 2])
    roots = _halfband_roots(N)
    inside = roots[np.abs(roots) < 1.0]
    assert len(inside) == N - 1, (len(inside), N)
    return _rebuild_filter(N, inside)


@functools.lru_cache(maxsize=None)
def _symlet(N: int):
    """Symlet-N (least-asymmetric Daubechies) orthonormal scaling filter
    (length 2N): same half-band spectral factorization as
    :func:`_daubechies`, but instead of taking every root inside the unit
    circle, each complex reciprocal quadruple {z, z̄, 1/z, 1/z̄}
    contributes either its inside or its outside conjugate pair — chosen
    (exhaustively, ≤ 2^7 candidates at N=16) to minimise the deviation of
    the filter's phase from linear, Daubechies' least-asymmetric
    criterion (Ten Lectures §8.1; pywt's symN uses the same selection).
    Real reciprocal pairs keep the inside root so ``Q`` stays real.
    Validated: sym2/sym3 coincide with db2/db3 (no complex quadruple to
    flip), sym4 reproduces the published table to ≤ 8e-13
    (tests/test_denoise_and_diff.py), and double-shift orthonormality
    holds to ≤ 2e-8 through sym16 — the same f32-grade cap as the db
    family. Host NumPy, cached per N."""
    import itertools

    if N == 1:
        return np.array([_SQRT2 / 2, _SQRT2 / 2])
    roots = _halfband_roots(N)
    inside = [z for z in roots if abs(z) < 1.0]
    assert len(inside) == N - 1, (len(inside), N)
    cplx = [z for z in inside if z.imag > 1e-12]
    real = [z for z in inside if abs(z.imag) <= 1e-12]

    w = np.linspace(0.01, np.pi - 0.01, 256)
    basis = np.stack([w, np.ones_like(w)], 1)

    def phase_nonlinearity(h):
        H = np.exp(-1j * np.outer(w, np.arange(h.shape[0]))) @ h
        ph = np.unwrap(np.angle(H))
        res = ph - basis @ np.linalg.lstsq(basis, ph, rcond=None)[0]
        return float(np.sum(res ** 2))

    # Time-reversing a filter (flipping EVERY quadruple) leaves the phase
    # nonlinearity mathematically unchanged, so each candidate has a
    # mirror twin at the same objective value: require a RELATIVE
    # improvement to replace the incumbent, so ties resolve to the
    # earliest enumeration (all-inside first — which is why sym2/sym3
    # come out as db2/db3 exactly, as in pywt). sym4 reproduces pywt's
    # published filter through the objective alone; for N > 4 the
    # mirror-twin choice is this enumeration's convention and bit parity
    # with pywt's tables is not claimed (same stance as db5+, PARITY.md).
    best, best_nl = None, np.inf
    for picks in itertools.product([False, True], repeat=len(cplx)):
        chosen = list(real)
        for z, flip in zip(cplx, picks):
            zz = 1.0 / np.conj(z) if flip else z
            chosen += [zz, np.conj(zz)]
        h = _rebuild_filter(N, np.array(chosen))
        nl = phase_nonlinearity(h)
        if nl < best_nl * (1.0 - 1e-6):
            best, best_nl = h, nl
    return best


_DB_MAX_N = 16
_SYM_MAX_N = 16


def _wavelet_filter(wavelet):
    """Resolve a wavelet name to its scaling filter, or refuse.

    'haar'/'db1'–'db4' come from the pinned tables; 'db5'–'db16' and
    'sym2'–'sym16' from the spectral-factorization generators
    (:func:`_daubechies` minimum-phase, :func:`_symlet` least-asymmetric
    — validated against the pinned db/sym4 tables and by orthonormality,
    tests/test_denoise_and_diff.py). Other pywt names (higher dbN/symN,
    coifN, biorX.Y, …) raise NotImplementedError — the reference forwards
    ``wavelet=`` to pywt (gpet_utils.py:134-140) and silent substitution
    would be worse than refusal."""
    if wavelet in _DB_FILTERS:
        return _DB_FILTERS[wavelet]
    for prefix, gen, cap in (("db", _daubechies, _DB_MAX_N),
                             ("sym", _symlet, _SYM_MAX_N)):
        if (isinstance(wavelet, str) and wavelet.startswith(prefix)
                and wavelet[len(prefix):].isdigit()):
            N = int(wavelet[len(prefix):])
            lo = 2 if prefix == "sym" else 1   # pywt's symN starts at sym2
            if lo <= N <= cap:
                return gen(N)
            raise NotImplementedError(
                f"native denoise_wavelet supports {prefix}{lo}.."
                f"{prefix}{cap}: the spectral-factorization construction "
                f"of {wavelet!r} exceeds f32-grade orthonormality "
                "(measured; see _daubechies/_symlet)")
    raise NotImplementedError(
        f"native denoise_wavelet supports 'haar', 'db1'..'db{_DB_MAX_N}' "
        f"and 'sym2'..'sym{_SYM_MAX_N}' only, got {wavelet!r} (the "
        "reference forwards this kwarg to pywt, gpet_utils.py:134-140; "
        "rather than silently substituting another wavelet we refuse)")


# Backwards-compatible alias (pre-r5 name, when only db was generated).
_db_filter = _wavelet_filter


def _qmf(h):
    """Quadrature-mirror highpass: g[j] = (-1)^j h[L-1-j]."""
    sign = np.where(np.arange(h.shape[0]) % 2 == 0, 1.0, -1.0)
    return sign * h[::-1]


def _wave_fwd_axis(x, h, g, axis):
    """One SYMMETRIC-EXTENSION analysis level along ``axis`` (pywt
    ``mode='symmetric'`` boundary semantics, the default the reference
    inherits through skimage → pywt, gpet_utils.py:134-140): the signal
    is extended by L−1 half-sample-mirrored samples each side
    (``[x_{L-2}..x_0 | x | x_{n-1}..x_{n-L+1}]``) and

        a[k] = Σ_j h[j] · ext[2k + 1 + j],   k < (n + L − 1) // 2

    (d with the QMF highpass g). The expansive output length and the
    phase/crop pairing with :func:`_wave_inv_axis` were fixed by
    exhaustive search for exact perfect reconstruction (pinned across
    db1–db4 × odd/even n in tests/test_denoise_and_diff.py). Static
    slices + flips only — no gathers. Requires ``n ≥ L`` (the level cap
    in :func:`denoise_wavelet` guarantees it, pywt ``dwt_max_level``)."""
    n = x.shape[axis]
    L = int(h.shape[0])
    assert n >= L, (n, L)
    left = jnp.flip(jax.lax.slice_in_dim(x, 0, L - 1, axis=axis),
                    axis=axis)
    right = jnp.flip(jax.lax.slice_in_dim(x, n - L + 1, n, axis=axis),
                     axis=axis)
    ext = jnp.concatenate([left, x, right], axis=axis)
    out_len = (n + L - 1) // 2
    lo = hi = None
    for j in range(L):
        xr = jax.lax.slice_in_dim(ext, 1 + j, 2 * out_len + j, stride=2,
                                  axis=axis)
        lo = h[j] * xr if lo is None else lo + h[j] * xr
        hi = g[j] * xr if hi is None else hi + g[j] * xr
    return lo, hi


def _wave_inv_axis(lo, hi, h, g, n, axis):
    """Inverse of :func:`_wave_fwd_axis`: upsample by 2, full-convolve
    with the reconstruction pair (rolls over a zero-tail-padded array ==
    shifts), sum, and crop the centred ``[L−2, L−2+n)`` window."""
    L = int(h.shape[0])
    up_shape = list(lo.shape)
    k = up_shape[axis]
    up_shape[axis] = 2 * k
    za = jnp.stack([lo, jnp.zeros_like(lo)], axis=axis + 1).reshape(up_shape)
    zd = jnp.stack([hi, jnp.zeros_like(hi)], axis=axis + 1).reshape(up_shape)
    if L > 2:
        pad = [(0, 0)] * za.ndim
        pad[axis] = (0, L - 2)
        za = jnp.pad(za, pad)
        zd = jnp.pad(zd, pad)
    out = None
    for j in range(L):
        # The tail padding is all zeros, so roll-in wraparound equals a
        # true shift (full convolution).
        ra = jnp.roll(za, j, axis=axis) if j else za
        rd = jnp.roll(zd, j, axis=axis) if j else zd
        term = h[j] * ra + g[j] * rd
        out = term if out is None else out + term
    c = max(L - 2, 0)
    return jax.lax.slice_in_dim(out, c, c + n, axis=axis)


def _filters(wavelet, dtype=jnp.float32):
    h_np = _wavelet_filter(wavelet)
    return jnp.asarray(h_np, dtype), jnp.asarray(_qmf(h_np), dtype)


def wave_dwt2(x, wavelet="db1"):
    """One 2-D analysis level: returns (LL, (LH, HL, HH), shape)."""
    h, g = _filters(wavelet, jnp.asarray(x).dtype)
    shape = x.shape
    lo, hi = _wave_fwd_axis(x, h, g, 0)
    ll, lh = _wave_fwd_axis(lo, h, g, 1)
    hl, hh = _wave_fwd_axis(hi, h, g, 1)
    return ll, (lh, hl, hh), shape


def wave_idwt2(ll, details, shape, wavelet="db1"):
    h, g = _filters(wavelet, jnp.asarray(ll).dtype)
    lh, hl, hh = details
    lo = _wave_inv_axis(ll, lh, h, g, shape[1], 1)
    hi = _wave_inv_axis(hl, hh, h, g, shape[1], 1)
    return _wave_inv_axis(lo, hi, h, g, shape[0], 0)


def _haar_fwd_axis(x, axis):
    n = x.shape[axis]
    if n % 2 == 1:                       # symmetric extension of odd axes
        edge = jax.lax.slice_in_dim(x, n - 1, n, axis=axis)
        x = jnp.concatenate([x, edge], axis=axis)
    a = jax.lax.slice_in_dim(x, 0, None, stride=2, axis=axis)
    b = jax.lax.slice_in_dim(x, 1, None, stride=2, axis=axis)
    return (a + b) / _SQRT2, (a - b) / _SQRT2


def _haar_inv_axis(lo, hi, n, axis):
    a = (lo + hi) / _SQRT2
    b = (lo - hi) / _SQRT2
    out = jnp.stack([a, b], axis=axis + 1)
    shape = list(lo.shape)
    shape[axis] *= 2
    out = out.reshape(shape)
    return jax.lax.slice_in_dim(out, 0, n, axis=axis)


def haar_dwt2(x):
    """One 2-D Haar analysis level: returns (LL, (LH, HL, HH), shape)."""
    shape = x.shape
    lo, hi = _haar_fwd_axis(x, 0)
    ll, lh = _haar_fwd_axis(lo, 1)
    hl, hh = _haar_fwd_axis(hi, 1)
    return ll, (lh, hl, hh), shape


def haar_idwt2(ll, details, shape):
    lh, hl, hh = details
    lo = _haar_inv_axis(ll, lh, shape[1], 1)
    hi = _haar_inv_axis(hl, hh, shape[1], 1)
    return _haar_inv_axis(lo, hi, shape[0], 0)


def estimate_sigma(image):
    """Noise std via MAD of the finest diagonal detail (Donoho-Johnstone;
    skimage.restoration.estimate_sigma semantics for 2-D input)."""
    _, (_, _, hh), _ = haar_dwt2(jnp.asarray(image))
    return jnp.median(jnp.abs(hh)) / 0.67448975019608171


def _soft(x, t):
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - t, 0.0)


def _bayes_thresh(detail, sigma2):
    """BayesShrink per-subband threshold t = sigma^2 / sigma_x (Chang et
    al. 2000, as in skimage's _bayes_thresh)."""
    dvar = jnp.mean(detail * detail)
    sig_x = jnp.sqrt(jnp.maximum(dvar - sigma2, 1e-12))
    t = sigma2 / sig_x
    # if the subband variance is all noise, kill the whole subband
    return jnp.where(dvar <= sigma2, jnp.max(jnp.abs(detail)) + 1.0, t)


def denoise_wavelet(image, sigma=None, wavelet="db1", mode="soft",
                    wavelet_levels=None, method="BayesShrink"):
    """Wavelet denoising (gpet_utils.py:134-140). Native Daubechies
    Daubechies multi-level DWT with BayesShrink/VisuShrink thresholding.

    Supported surface: ``wavelet`` 'haar' or 'db1'..'db16' (db5+ filters
    generated by spectral factorization, :func:`_daubechies`; other pywt
    names raise NotImplementedError — no silent substitution), ``mode``
    'soft'/'hard', ``method`` 'BayesShrink'
    (per-subband adaptive) or 'VisuShrink' (universal threshold).
    ``wavelet_levels`` defaults to skimage's ``max_level - 3`` (floor 1).
    ``sigma=None`` estimates the noise from the finest diagonal detail of
    the SAME wavelet's decomposition via MAD (skimage's
    ``_wavelet_threshold`` behaviour).
    """
    _filters(wavelet)                       # validate the name up front
    x = jnp.asarray(image, jnp.float32)
    # pywt.dwt_max_level(n, L) = floor(log2(n / (L - 1))) — with the
    # symmetric-extension transform every level needs n >= L.
    L = len(_wavelet_filter(wavelet))
    max_level = int(np.floor(np.log2(min(x.shape) / max(L - 1, 1))))
    if wavelet_levels is None:
        wavelet_levels = max(max_level - 3, 1)
    wavelet_levels = max(min(wavelet_levels, max_level), 0)
    if wavelet_levels == 0:       # image smaller than one filter support
        return x

    ll = x
    pyramid = []
    for _ in range(wavelet_levels):
        ll, details, shape = wave_dwt2(ll, wavelet)
        pyramid.append((details, shape))

    if sigma is None:
        hh_fine = pyramid[0][0][2]
        sig = jnp.median(jnp.abs(hh_fine)) / 0.67448975019608171
    else:
        sig = jnp.asarray(sigma, jnp.float32)
    sigma2 = sig ** 2

    for lvl in range(wavelet_levels - 1, -1, -1):
        details, shape = pyramid[lvl]
        new = []
        for d in details:
            if method == "BayesShrink":
                t = _bayes_thresh(d, sigma2)
            elif method == "VisuShrink":
                t = jnp.sqrt(sigma2) * jnp.sqrt(2.0 * np.log(x.size))
            else:
                raise NotImplementedError(method)
            new.append(_soft(d, t) if mode == "soft"
                       else jnp.where(jnp.abs(d) > t, d, 0.0))
        ll = wave_idwt2(ll, tuple(new), shape, wavelet)
    return ll


# ---------------------------------------------------------------------------
# TV-Bregman (the reference's 'tvb' technique, gpet_utils.py:140 ->
# skimage.restoration.denoise_tv_bregman). Split-Bregman iteration for
# the (an)isotropic ROF model  min_u  weight/2 ||u-f||^2 + TV(u)
# (Goldstein & Osher 2009) — same model and weight semantics as skimage
# (larger weight = closer to the input); the inner solver differs
# (damped-Jacobi sweeps instead of Gauss-Seidel), documented in PARITY.md.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("max_num_iter", "isotropic"))
def denoise_tv_bregman(image, weight=5.0, max_num_iter=100, eps=1e-3,
                       isotropic=True):
    f = jnp.asarray(image, jnp.float32)
    mu = 2.0 * jnp.asarray(weight, jnp.float32)  # split penalty
    w = jnp.asarray(weight, jnp.float32)

    def grad(u):
        gx = jnp.diff(u, axis=1, append=u[:, -1:])
        gy = jnp.diff(u, axis=0, append=u[-1:, :])
        return gx, gy

    def div(px, py):
        dx = jnp.concatenate([px[:, :1], px[:, 1:-1] - px[:, :-2],
                              -px[:, -2:-1]], axis=1)
        dy = jnp.concatenate([py[:1, :], py[1:-1, :] - py[:-2, :],
                              -py[-2:-1, :]], axis=0)
        return dx + dy

    def shrink(gx, gy):
        if isotropic:
            mag = jnp.sqrt(gx * gx + gy * gy)
            scale = jnp.maximum(mag - 1.0 / mu, 0.0) / jnp.maximum(mag,
                                                                   1e-12)
            return gx * scale, gy * scale
        return _soft(gx, 1.0 / mu), _soft(gy, 1.0 / mu)

    def laplace_jacobi(u, rhs, n_sweeps=4):
        # (w - mu*Lap) u = rhs, damped Jacobi with 4-neighbour stencil.
        def sweep(_, u):
            nb = (jnp.pad(u, ((0, 0), (1, 0)), mode="edge")[:, :-1]
                  + jnp.pad(u, ((0, 0), (0, 1)), mode="edge")[:, 1:]
                  + jnp.pad(u, ((1, 0), (0, 0)), mode="edge")[:-1, :]
                  + jnp.pad(u, ((0, 1), (0, 0)), mode="edge")[1:, :])
            return (rhs + mu * nb) / (w + 4.0 * mu)
        return jax.lax.fori_loop(0, n_sweeps, sweep, u)

    def body(state):
        u, dx, dy, bx, by, k, err = state
        # (w - mu*Lap) u = w f + mu div(b - d): Goldstein-Osher u-update,
        # whose lambda*grad^T(d - b) term is -div(d - b).
        rhs = w * f + mu * div(bx - dx, by - dy)
        u_new = laplace_jacobi(u, rhs)
        gx, gy = grad(u_new)
        dx_new, dy_new = shrink(gx + bx, gy + by)
        bx_new = bx + gx - dx_new
        by_new = by + gy - dy_new
        err = jnp.sqrt(jnp.mean((u_new - u) ** 2)) / jnp.maximum(
            jnp.sqrt(jnp.mean(u_new * u_new)), 1e-12)
        return u_new, dx_new, dy_new, bx_new, by_new, k + 1, err

    def cond(state):
        *_, k, err = state
        return (k < max_num_iter) & (err > eps)

    z = jnp.zeros_like(f)
    state = (f, z, z, z, z, jnp.asarray(0, jnp.int32),
             jnp.asarray(jnp.inf, jnp.float32))
    u, *_ = jax.lax.while_loop(cond, body, state)
    return u
