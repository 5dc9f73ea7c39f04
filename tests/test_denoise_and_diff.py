"""Native denoisers, quality metrics, finite differencing."""

import numpy as np
import jax.numpy as jnp
import pytest

from gaussian_process_edge_trace_tpu.ops.diff import finite_diff
from gaussian_process_edge_trace_tpu.utils.denoise_native import (
    denoise_nl_means, denoise_tv_chambolle, normalized_root_mse,
    peak_signal_noise_ratio, shannon_entropy, structural_similarity)
from gaussian_process_edge_trace_tpu.utils.image import denoise


def _noisy_pair(seed=0, shape=(48, 48), sigma=0.1):
    rng = np.random.RandomState(seed)
    clean = np.zeros(shape)
    clean[:, shape[1] // 2:] = 1.0
    clean[shape[0] // 3:, :] *= 0.7
    noisy = clean + rng.normal(0, sigma, shape)
    return clean, noisy


def _tv(img):
    img = np.asarray(img)
    return (np.abs(np.diff(img, axis=0)).sum()
            + np.abs(np.diff(img, axis=1)).sum())


def test_finite_diff_matches_reference_loop():
    rng = np.random.RandomState(1)
    y = rng.normal(size=17)
    for typ in (0, 1, 2):
        lower, upper = [(0, 16), (1, 17), (1, 16)][typ]
        b, a = [(1, 0), (0, -1), (-1, 1)][typ]
        want = np.array([y[i + b] - y[i + a] for i in range(lower, upper)])
        got = np.asarray(finite_diff(jnp.asarray(y), typ=typ))
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_tv_chambolle_denoises():
    clean, noisy = _noisy_pair()
    out = np.asarray(denoise_tv_chambolle(noisy, weight=0.15))
    assert _tv(out) < 0.5 * _tv(noisy)
    # Closer to the clean image than the noisy input is.
    assert np.mean((out - clean) ** 2) < 0.5 * np.mean((noisy - clean) ** 2)


@pytest.mark.slow
def test_nl_means_denoises():
    clean, noisy = _noisy_pair(sigma=0.08)
    out = np.asarray(denoise_nl_means(noisy, patch_size=5,
                                      patch_distance=5, h=0.12))
    assert np.mean((out - clean) ** 2) < 0.6 * np.mean((noisy - clean) ** 2)


@pytest.mark.slow
def test_denoise_dispatch_paths(capsys):
    clean, noisy = _noisy_pair()
    for tech, kw in [("gaussian", {"sigma": 1.0}), ("median", {"size": 3}),
                     ("minimum", {"size": 3}),
                     ("tvc", {"weight": 0.1}),
                     ("nl", {"patch_size": 5, "patch_distance": 3,
                             "h": 0.1})]:
        out = denoise(noisy, tech, kw, verbose=True)
        assert out.shape == noisy.shape
    report = capsys.readouterr().out
    assert "Peak-SNR" in report and "Shannon Entropy" in report
    assert denoise(noisy, "nope", {}) is None


def test_quality_metrics_formulas():
    rng = np.random.RandomState(2)
    a = rng.uniform(0, 1, (32, 32))
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1)
    mse = np.mean((a - b) ** 2)
    dr = a.max() - a.min()
    np.testing.assert_allclose(float(peak_signal_noise_ratio(a, b)),
                               10 * np.log10(dr ** 2 / mse), rtol=1e-10)
    np.testing.assert_allclose(float(normalized_root_mse(a, b)),
                               np.sqrt(mse) / dr, rtol=1e-10)
    s = float(structural_similarity(a, b))
    assert 0.0 < s < 1.0
    assert float(structural_similarity(a, a)) == pytest.approx(1.0)
    e = float(shannon_entropy(np.zeros((8, 8))))
    assert e == pytest.approx(0.0, abs=1e-9)
    e2 = float(shannon_entropy(rng.uniform(0, 1, (64, 64))))
    assert e2 > 5.0


def _noisy_pair(seed=0, shape=(64, 64), sigma=0.08):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    clean = 0.5 + 0.4 * np.sin(xx / 7.0) * np.cos(yy / 9.0)
    noisy = clean + rng.normal(0, sigma, shape)
    return clean.astype(np.float32), noisy.astype(np.float32)


def test_haar_dwt_perfect_reconstruction():
    from gaussian_process_edge_trace_tpu.utils.denoise_native import (
        haar_dwt2, haar_idwt2)
    rng = np.random.default_rng(1)
    for shape in [(32, 32), (33, 47), (64, 31)]:
        x = rng.normal(size=shape).astype(np.float32)
        ll, details, s = haar_dwt2(jnp.asarray(x))
        rec = np.asarray(haar_idwt2(ll, details, s))
        np.testing.assert_allclose(rec, x, atol=1e-5)


def test_estimate_sigma_on_pure_noise():
    from gaussian_process_edge_trace_tpu.utils.denoise_native import (
        estimate_sigma)
    rng = np.random.default_rng(2)
    noise = rng.normal(0, 0.1, (256, 256)).astype(np.float32)
    est = float(estimate_sigma(jnp.asarray(noise)))
    assert abs(est - 0.1) < 0.01, est


@pytest.mark.parametrize("technique,kwargs", [
    ("wavelet", {}),
    ("wavelet", {"method": "VisuShrink", "mode": "hard"}),
    ("tvb", {"weight": 8.0}),
    ("tvb", {"weight": 8.0, "isotropic": False}),
])
def test_wavelet_and_tvb_denoise_improve_psnr(technique, kwargs):
    """The last C18 branches (gpet_utils.py:138-140) run natively and
    actually denoise: PSNR vs the clean image improves over the noisy
    input, and the output stays close to the input in the mean."""
    from gaussian_process_edge_trace_tpu.utils.denoise_native import (
        peak_signal_noise_ratio)
    from gaussian_process_edge_trace_tpu.utils.image import denoise

    clean, noisy = _noisy_pair()
    out = np.asarray(denoise(noisy, technique, kwargs))
    assert out.shape == noisy.shape
    p_noisy = float(peak_signal_noise_ratio(jnp.asarray(clean),
                                            jnp.asarray(noisy)))
    p_out = float(peak_signal_noise_ratio(jnp.asarray(clean),
                                          jnp.asarray(out)))
    assert p_out > p_noisy + 1.0, (p_noisy, p_out)
    assert abs(out.mean() - noisy.mean()) < 0.02


def test_tvb_weight_semantics():
    """Larger weight = closer to the input (skimage's weight contract)."""
    from gaussian_process_edge_trace_tpu.utils.image import denoise
    _, noisy = _noisy_pair()
    d_small = np.asarray(denoise(noisy, "tvb", {"weight": 2.0}))
    d_large = np.asarray(denoise(noisy, "tvb", {"weight": 50.0}))
    r_small = float(np.mean((d_small - noisy) ** 2))
    r_large = float(np.mean((d_large - noisy) ** 2))
    assert r_large < r_small


def test_db_filters_are_orthonormal():
    """The hardcoded Daubechies filters satisfy the defining conditions:
    sum h = sqrt(2), ||h|| = 1, double-shift orthogonality, and the QMF
    highpass has zero mean."""
    from gaussian_process_edge_trace_tpu.utils.denoise_native import (
        _DB_FILTERS, _qmf)
    for name, h in _DB_FILTERS.items():
        g = _qmf(h)
        assert abs(h.sum() - np.sqrt(2)) < 1e-10, name
        assert abs((h * h).sum() - 1.0) < 1e-10, name
        assert abs(g.sum()) < 1e-10, name
        L = len(h)
        hp = np.pad(h, (0, L))
        for s in range(1, L // 2):
            assert abs(np.dot(hp[:L], hp[2 * s:2 * s + L])) < 1e-10, (
                name, s)


@pytest.mark.parametrize("wavelet", ["db1", "db2", "db3", "db4", "db8"])
def test_wave_dwt_perfect_reconstruction(wavelet):
    """the db-family DWT is a true orthonormal
    transform — analysis followed by synthesis is the identity, on even
    AND odd axis lengths (db8 exercises a GENERATED filter end-to-end)."""
    from gaussian_process_edge_trace_tpu.utils.denoise_native import (
        wave_dwt2, wave_idwt2)
    rng = np.random.default_rng(3)
    for shape in [(32, 32), (33, 47), (64, 31)]:
        x = rng.normal(size=shape)
        ll, details, s = wave_dwt2(jnp.asarray(x), wavelet)
        rec = np.asarray(wave_idwt2(ll, details, s, wavelet))
        np.testing.assert_allclose(rec, x, atol=1e-7)


def test_daubechies_generator_matches_pinned_tables():
    """The spectral-factorization generator (denoise_native._daubechies)
    reproduces the pinned db1-db4 coefficient tables — the same tables
    that were validated against pywt conventions — to f64 root-finding
    accuracy, and its higher-N filters hold the defining orthonormality
    conditions to below f32 resolution through the db16 support cap."""
    from gaussian_process_edge_trace_tpu.utils.denoise_native import (
        _DB_FILTERS, _DB_MAX_N, _daubechies, _db_filter, _qmf)
    for name, N in [("db1", 1), ("db2", 2), ("db3", 3), ("db4", 4)]:
        np.testing.assert_allclose(_daubechies(N), _DB_FILTERS[name],
                                   atol=5e-12, err_msg=name)
    for N in [5, 8, 12, _DB_MAX_N]:
        h = _daubechies(N)
        assert len(h) == 2 * N
        assert abs(h.sum() - np.sqrt(2)) < 1e-9
        assert abs((h * h).sum() - 1.0) < 2e-8
        g = _qmf(h)
        assert abs(g.sum()) < 1e-9
        hp = np.pad(h, (0, 2 * N))
        for s in range(1, N):
            assert abs(np.dot(hp[:2 * N], hp[2 * s:2 * s + 2 * N])) \
                < 2e-8, (N, s)
    # resolver: generated names route through the generator; beyond the
    # cap the error message is precision-honest.
    np.testing.assert_array_equal(_db_filter("db8"), _daubechies(8))
    with pytest.raises(NotImplementedError, match="db1..db16"):
        _db_filter("db17")


@pytest.mark.parametrize("wavelet", ["db2", "db4"])
@pytest.mark.parametrize("n", [24, 25])
def test_wave_fwd_matches_numpy_oracle(wavelet, n):
    """One analysis level along one axis vs an independent direct-sum
    NumPy oracle of the SYMMETRIC-extension convolution (pywt
    'symmetric' boundary semantics): extend by L-1
    half-sample-mirrored samples each side, a[k] = sum_j h[j]
    ext[2k+1+j] for k < (n+L-1)//2 (and d with the QMF highpass)."""
    from gaussian_process_edge_trace_tpu.utils.denoise_native import (
        _DB_FILTERS, _filters, _qmf, _wave_fwd_axis)
    h_np = _DB_FILTERS[wavelet]
    g_np = _qmf(h_np)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, n))
    L = len(h_np)
    ext = np.concatenate([x[0, :L - 1][::-1], x[0],
                          x[0, n - L + 1:][::-1]])
    out_len = (n + L - 1) // 2
    a = np.zeros(out_len)
    d = np.zeros(out_len)
    for k in range(out_len):
        for j in range(L):
            a[k] += h_np[j] * ext[2 * k + 1 + j]
            d[k] += g_np[j] * ext[2 * k + 1 + j]
    h, g = _filters(wavelet, jnp.float64)
    lo, hi = _wave_fwd_axis(jnp.asarray(x), h, g, axis=1)
    assert lo.shape == (1, out_len)
    np.testing.assert_allclose(np.asarray(lo)[0], a, atol=1e-12)
    np.testing.assert_allclose(np.asarray(hi)[0], d, atol=1e-12)


@pytest.mark.parametrize("wavelet", ["db2", "db4"])
def test_db_wavelet_denoise_improves_psnr(wavelet):
    """denoise(technique='wavelet', wavelet='db2'/'db4') runs the REAL
    requested wavelet (no silent Haar substitution) and denoises."""
    from gaussian_process_edge_trace_tpu.utils.denoise_native import (
        peak_signal_noise_ratio)
    from gaussian_process_edge_trace_tpu.utils.image import denoise

    clean, noisy = _noisy_pair()
    out = np.asarray(denoise(noisy, "wavelet", {"wavelet": wavelet}))
    p_noisy = float(peak_signal_noise_ratio(jnp.asarray(clean),
                                            jnp.asarray(noisy)))
    p_out = float(peak_signal_noise_ratio(jnp.asarray(clean),
                                          jnp.asarray(out)))
    assert p_out > p_noisy + 1.0, (p_noisy, p_out)
    # db2 output differs from the Haar output: the kwarg is honoured.
    haar = np.asarray(denoise(noisy, "wavelet", {"wavelet": "db1"}))
    assert np.abs(out - haar).max() > 1e-4


def test_unsupported_wavelet_refused():
    """A pywt wavelet name outside the implemented set raises instead of
    silently computing another wavelet."""
    from gaussian_process_edge_trace_tpu.utils.image import denoise
    _, noisy = _noisy_pair()
    with pytest.raises(NotImplementedError, match="coif2"):
        denoise(noisy, "wavelet", {"wavelet": "coif2"})
    with pytest.raises(NotImplementedError, match="sym2..sym16"):
        denoise(noisy, "wavelet", {"wavelet": "sym17"})


def test_symlet_generator_matches_pinned_table():
    """The least-asymmetric factorization (denoise_native._symlet)
    reproduces the published sym4 filter (Daubechies, Ten Lectures
    Table 6.3 — the table pywt ships) to f64 root-finding accuracy, with
    NO convention fix-ups: the phase-nonlinearity minimum alone selects
    pywt's filter. sym2/sym3 must coincide with db2/db3 (a single complex
    root quadruple — nothing to flip), and every symN through the sym16
    cap holds the defining orthonormality conditions below f32
    resolution."""
    from gaussian_process_edge_trace_tpu.utils.denoise_native import (
        _SYM_MAX_N, _daubechies, _qmf, _symlet, _wavelet_filter)
    pywt_sym4_rec_lo = np.array([
        0.03222310060404270, -0.012603967262037833, -0.09921954357684722,
        0.29785779560527736, 0.8037387518059161, 0.49761866763201545,
        -0.029635527645998511, -0.07576571478927333])
    np.testing.assert_allclose(_symlet(4), pywt_sym4_rec_lo, atol=5e-12)
    # sym4 genuinely differs from db4 (the selection did something).
    assert np.abs(_symlet(4) - _daubechies(4)).max() > 0.1
    for N in (2, 3):
        np.testing.assert_allclose(_symlet(N), _daubechies(N), atol=5e-12)
    for N in [5, 8, 12, _SYM_MAX_N]:
        h = _symlet(N)
        assert len(h) == 2 * N
        assert abs(h.sum() - np.sqrt(2)) < 1e-9
        assert abs((h * h).sum() - 1.0) < 2e-8
        assert abs(_qmf(h).sum()) < 1e-9
        hp = np.pad(h, (0, 2 * N))
        for s in range(1, N):
            assert abs(np.dot(hp[:2 * N], hp[2 * s:2 * s + 2 * N])) \
                < 2e-8, (N, s)
    np.testing.assert_array_equal(_wavelet_filter("sym8"), _symlet(8))


def test_symlet_dwt_perfect_reconstruction_and_denoise():
    """sym8 runs end-to-end: the DWT round-trips exactly (orthonormal
    filter through the symmetric-extension transform) and
    denoise(wavelet='sym4') produces a result distinct from db4's (the
    kwarg selects the REAL symlet)."""
    from gaussian_process_edge_trace_tpu.utils.denoise_native import (
        peak_signal_noise_ratio, wave_dwt2, wave_idwt2)
    from gaussian_process_edge_trace_tpu.utils.image import denoise
    rng = np.random.default_rng(5)
    for shape in [(33, 47), (64, 31)]:
        x = rng.normal(size=shape)
        ll, details, s = wave_dwt2(jnp.asarray(x), "sym8")
        rec = np.asarray(wave_idwt2(ll, details, s, "sym8"))
        np.testing.assert_allclose(rec, x, atol=1e-6)
    clean, noisy = _noisy_pair()
    out = np.asarray(denoise(noisy, "wavelet", {"wavelet": "sym4"}))
    p_noisy = float(peak_signal_noise_ratio(jnp.asarray(clean),
                                            jnp.asarray(noisy)))
    p_out = float(peak_signal_noise_ratio(jnp.asarray(clean),
                                          jnp.asarray(out)))
    assert p_out > p_noisy + 1.0, (p_noisy, p_out)
    db4 = np.asarray(denoise(noisy, "wavelet", {"wavelet": "db4"}))
    assert np.abs(out - db4).max() > 1e-4
