"""Trace-pipeline unit tests vs the NumPy reference oracles."""

import numpy as np
import pytest
import jax.numpy as jnp

from gaussian_process_edge_trace_tpu.trace.kde import curve_kde, gradient_kde
from gaussian_process_edge_trace_tpu.trace.scoring import (
    best_curves, curve_costs)
from gaussian_process_edge_trace_tpu.trace.select import (
    make_bin_spec, select_pixels)

from reference_oracle import (
    oracle_cost, oracle_gradient_kde, oracle_kde, oracle_kde_direct,
    oracle_select)


# ---------------------------------------------------------------------------
# KDE
# ---------------------------------------------------------------------------

def _random_curves(rng, M, N, x_st, E, S):
    y = (M / 2 + (M / 4) * np.sin(np.linspace(0, 3, E))[:, None]
         + rng.normal(0, M / 10, (E, S)))
    return y


def test_curve_kde_matches_oracle():
    rng = np.random.RandomState(0)
    M, N, x_st, E, S = 37, 53, 4, 45, 7
    y = _random_curves(rng, M, N, x_st, E, S)
    # Push some points out of the image to exercise the deletion rule.
    y[:, 0] += M
    w = rng.uniform(0.5, 2.0, S)

    got = np.asarray(curve_kde(jnp.asarray(y), jnp.asarray(w), M, N, x_st))

    xs = np.arange(x_st, x_st + E)
    pts = np.stack([np.tile(xs[:, None], (1, S)).ravel(), y.ravel()], axis=1)
    wpts = np.tile(w[None, :], (E, 1)).ravel()
    want = oracle_kde(pts, wpts, M, N)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _binning_oracle(y, w, M):
    """Two-tap linear binning by np.add.at: each in-image point puts
    w·(1−f) on padded row floor(y)+1 and w·f on the row after; points
    outside [0, M-1] are deleted (gpet.py:498-500)."""
    E, S = y.shape
    H = np.zeros((M + 2, E))
    ee = np.broadcast_to(np.arange(E)[:, None], (E, S))
    ww = np.broadcast_to(w[None, :], (E, S))
    keep = (y >= 0) & (y <= M - 1)
    yp = y[keep] + 1.0
    lo = np.floor(yp).astype(int)
    f = yp - lo
    np.add.at(H, (lo, ee[keep]), ww[keep] * (1.0 - f))
    np.add.at(H, (np.minimum(lo + 1, M + 1), ee[keep]), ww[keep] * f)
    return H


@pytest.mark.parametrize("E,S,M,chunk_samples", [
    (500, 100, 500, None),     # demo kept-curve shape, one block
    (37, 33, 129, None),       # odd E and M
    (48, 5000, 257, 2048),     # 3 chunks, the last one padded
    (1000, 1000, 1000, 16),    # the 1000² S=10⁴ kept-curve shape, chunked
])
def test_column_binning_matches_two_tap_oracle(E, S, M, chunk_samples,
                                               monkeypatch):
    """trace/kde.py::column_binning (the dense hat contraction, scanned in
    chunks above _CHUNK_ELEMS) vs a NumPy two-tap np.add.at oracle, with
    exact integers, both image edges and out-of-image points."""
    from gaussian_process_edge_trace_tpu.trace import kde

    if chunk_samples is not None:
        monkeypatch.setattr(kde, "_CHUNK_ELEMS",
                            (M + 2) * E * chunk_samples)
    rng = np.random.default_rng(7)
    y = rng.uniform(-3, M + 2, (E, S))
    y[:, :4] = [0.0, M - 1.0, M / 2, -1.0]
    w = rng.random(S)
    got = np.asarray(kde.column_binning(jnp.asarray(y), jnp.asarray(w), M))
    want = _binning_oracle(y, w, M)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_curve_kde_close_to_direct_gaussian_sum():
    # Binned KDE must preserve the *shape* of the direct Gaussian-sum KDE
    # (rank correlation drives pixel selection, SURVEY.md §7).
    rng = np.random.RandomState(1)
    M, N, x_st, E, S = 30, 40, 2, 35, 5
    y = _random_curves(rng, M, N, x_st, E, S)
    w = rng.uniform(0.5, 2.0, S)
    got = np.asarray(curve_kde(jnp.asarray(y), jnp.asarray(w), M, N, x_st))
    xs = np.arange(x_st, x_st + E)
    pts = np.stack([np.tile(xs[:, None], (1, S)).ravel(), y.ravel()], axis=1)
    wpts = np.tile(w[None, :], (E, 1)).ravel()
    direct = oracle_kde_direct(pts, wpts, M, N)
    # Linear binning at bw=1 carries an inherent few-percent discretisation
    # error vs the exact Gaussian sum — KDEpy's FFTKDE has the same one.
    np.testing.assert_allclose(got, direct, atol=0.06)
    corr = np.corrcoef(got.ravel(), direct.ravel())[0, 1]
    assert corr > 0.999


def test_separable_blur_per_axis_gate(monkeypatch):
    """The blur size gate is per axis (gpet.py:514's FFTKDE blurs any
    (M, N)): a grid with one long axis runs that axis as shifted FMAs and
    the short one as a Toeplitz matmul, and every gate combination agrees
    with the all-dense form (same separable convolution, f64 oracle)."""
    from gaussian_process_edge_trace_tpu.trace import kde

    rng = np.random.RandomState(7)
    grid = jnp.asarray(rng.uniform(0, 1, (40, 90)))
    taps = kde.gaussian_taps(kde.DEFAULT_RADIUS, 1.0, grid.dtype)
    dense = np.asarray(kde._separable_blur(grid, taps))

    monkeypatch.setattr(kde, "_BLUR_MATMUL_MAX", 64)  # axis0 dense, axis1 FMA
    mixed = np.asarray(kde._separable_blur(grid, taps))
    # blur_matrices must hand back (Ty, None) in this regime, and feeding
    # that tuple through reproduces the self-gated result.
    mats = kde.blur_matrices(38, 88, dtype=grid.dtype)  # +2 pad -> (40, 90)
    assert mats[0] is not None and mats[1] is None
    via_mats = np.asarray(kde._separable_blur(grid, taps, mats=mats))

    monkeypatch.setattr(kde, "_BLUR_MATMUL_MAX", 10)   # both axes FMA
    fma = np.asarray(kde._separable_blur(grid, taps))
    assert kde.blur_matrices(38, 88, dtype=grid.dtype) is None

    np.testing.assert_allclose(mixed, dense, rtol=0, atol=1e-14)
    np.testing.assert_allclose(via_mats, mixed, rtol=0, atol=1e-14)
    np.testing.assert_allclose(fma, dense, rtol=0, atol=1e-14)


def test_gradient_kde_matches_oracle():
    rng = np.random.RandomState(2)
    M, N = 41, 33
    grad = rng.uniform(0, 1, (M, N))
    grad[grad < 0.4] = 0.0
    got = np.asarray(gradient_kde(jnp.asarray(grad)))
    want = oracle_gradient_kde(grad)
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# Curve cost
# ---------------------------------------------------------------------------

def test_curve_costs_match_oracle():
    rng = np.random.RandomState(3)
    M, N, x_st, E, S = 48, 64, 5, 50, 9
    grad = rng.uniform(0, 1, (M, N))
    x = np.arange(x_st, x_st + E)
    y = _random_curves(rng, M, N, x_st, E, S)
    got = np.asarray(curve_costs(jnp.asarray(grad), jnp.asarray(x),
                                 jnp.asarray(y)))
    want = np.array([oracle_cost(grad, x, y[:, s]) for s in range(S)])
    np.testing.assert_allclose(got, want, rtol=1e-10)


def _cost_case(rng, M, E, S):
    grad = rng.uniform(0, 1, (M, E + 8))
    x = np.arange(3, 3 + E)
    y = _random_curves(rng, M, M, 3, E, S)
    y[:, :3] = [-4.0, M + 4.0, M - 1.0]        # clamped at both edges
    return grad, x, y


@pytest.mark.parametrize("E,S,even", [
    (48, 160, "simpson"),   # one row chunk; S % block != 0: masked edge
    (200, 70, "simpson"),   # 99 pairs over 4 row chunks, the last partial
    (134, 40, "avg"),       # even E: the "avg" rule coincides
    (37, 11, "simpson"),    # odd E: kernel block + Cartwright tail
    (71, 20, "avg"),        # odd E: two kernel passes + trapezoids
    (5, 9, "avg"),          # smallest odd E
])
def test_fused_cost_kernel_matches_curve_costs(E, S, even):
    """ops/fused_cost.py (the Triton kernel, here in the Pallas
    interpreter) vs the plain curve_costs path and the per-curve NumPy
    oracle: f32 reassociation only."""
    from gaussian_process_edge_trace_tpu.ops.fused_cost import (
        fused_curve_costs)

    rng = np.random.RandomState(E + S)
    M = 64
    grad, x, y = _cost_case(rng, M, E, S)
    cols = jnp.asarray(grad.T[x], jnp.float32)
    got = np.asarray(fused_curve_costs(cols, jnp.asarray(y, jnp.float32),
                                       kde_thresh=1e-3, even=even,
                                       interpret=True))
    plain = np.asarray(curve_costs(jnp.asarray(grad), jnp.asarray(x),
                                   jnp.asarray(y), even=even))
    np.testing.assert_allclose(got, plain, rtol=1e-5)
    if even == "simpson":
        want = np.array([oracle_cost(grad, x, y[:, s]) for s in range(S)])
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fused_cost_path_choice(monkeypatch):
    """The kernel-or-plain choice (scoring.use_fused_cost) is keyed on the
    platform alone: the kernel on a GPU for every E >= 4, odd or even; the
    kernel refuses E < 4, and the plain path scores those."""
    import jax

    from gaussian_process_edge_trace_tpu.ops.fused_cost import (
        fused_curve_costs)
    from gaussian_process_edge_trace_tpu.trace import scoring

    assert not scoring.use_fused_cost(500)               # on the CPU
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert scoring.use_fused_cost(500)
    assert scoring.use_fused_cost(499)                   # odd E too
    assert not scoring.use_fused_cost(3)
    monkeypatch.undo()

    rng = np.random.RandomState(9)
    grad, x, y = _cost_case(rng, 40, 3, 11)
    with pytest.raises(ValueError, match="E >= 4"):
        fused_curve_costs(jnp.asarray(grad.T[x]), jnp.asarray(y),
                          interpret=True)
    got = np.asarray(curve_costs(jnp.asarray(grad), jnp.asarray(x),
                                 jnp.asarray(y)))
    want = np.array([oracle_cost(grad, x, y[:, s]) for s in range(11)])
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("E", [40, 41])
def test_fused_cost_independent_of_draw_width(E):
    """A sample's cost from the kernel has the same bits whether it is
    scored with the whole draw or with a slice of it — what lets a
    sample-sharded trace score its shard as one device scores the draw."""
    from gaussian_process_edge_trace_tpu.ops.fused_cost import (
        fused_curve_costs)

    rng = np.random.RandomState(E)
    grad, x, y = _cost_case(rng, 64, E, 150)
    cols = jnp.asarray(grad.T[x], jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    whole = np.asarray(fused_curve_costs(cols, y, interpret=True))
    for lo, hi in [(0, 75), (75, 150), (37, 113)]:
        part = np.asarray(fused_curve_costs(cols, y[:, lo:hi],
                                            interpret=True))
        np.testing.assert_array_equal(part, whole[lo:hi])


def test_best_curves_topk():
    rng = np.random.RandomState(4)
    E, S, K = 20, 30, 5
    ys = rng.normal(size=(E, S))
    costs = rng.uniform(1, 2, S)
    bc, bcosts = best_curves(jnp.asarray(ys), jnp.asarray(costs), K)
    order = np.argsort(costs)[:K]
    np.testing.assert_allclose(np.asarray(bcosts), costs[order])
    np.testing.assert_allclose(np.asarray(bc), ys[:, order])


# ---------------------------------------------------------------------------
# Pixel selection
# ---------------------------------------------------------------------------

def _run_select(kde, gkde, pre_xy, thresh, x_st, x_en, delta_x,
                pixel_thresh, algo_thresh, fix_endpoints):
    M, N = kde.shape
    spec = make_bin_spec(N, x_st, x_en, delta_x)
    B = spec.n_bins
    P = max(len(pre_xy), 1)
    ox = np.zeros(P, np.int32)
    oy = np.zeros(P, np.int32)
    ov = np.zeros(P, bool)
    for i, (x, y) in enumerate(pre_xy):
        ox[i], oy[i], ov[i] = x, y, True
    sel = select_pixels(
        jnp.asarray(kde), jnp.asarray(gkde), jnp.asarray(ox),
        jnp.asarray(oy), jnp.asarray(ov),
        jnp.asarray(len(pre_xy), jnp.int32),
        jnp.asarray(thresh, jnp.float64), spec,
        fix_endpoints, 1e-3, pixel_thresh, algo_thresh)
    got = {(int(x), int(y))
           for x, y, v in zip(sel.obs_x, sel.obs_y, sel.obs_valid) if v}
    return got, float(sel.score_thresh), int(sel.n_fobs)


@pytest.mark.parametrize("fix_endpoints", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_matches_oracle(seed, fix_endpoints):
    rng = np.random.RandomState(seed)
    M, N = 40, 60
    x_st, x_en, delta_x = 3, 55, 5
    pixel_thresh, algo_thresh = 3, 8
    # A KDE concentrated near a band, so candidates are sparse.
    kde = np.zeros((M, N))
    yc = (M / 2 + 6 * np.sin(np.linspace(0, 3, N))).astype(int)
    for x in range(N):
        kde[max(yc[x] - 3, 0):yc[x] + 3, x] = rng.uniform(0.2, 1.0, size=(
            min(yc[x] + 3, M) - max(yc[x] - 3, 0)))
    kde /= kde.max()
    gkde = rng.uniform(0, 1, (M, N))
    pre_xy = [(10, yc[10]), (25, yc[25] + 1), (40, 0)]  # last: kde=0, drops

    want_fobs, want_thresh = oracle_select(
        kde, gkde, np.array(pre_xy), 0.7, x_st, x_en, delta_x,
        pixel_thresh, algo_thresh, fix_endpoints)
    got, got_thresh, got_n = _run_select(
        kde, gkde, pre_xy, 0.7, x_st, x_en, delta_x, pixel_thresh,
        algo_thresh, fix_endpoints)

    assert got_n == want_fobs.shape[0]
    assert got == {(int(x), int(y)) for x, y in want_fobs}
    np.testing.assert_allclose(got_thresh, want_thresh, rtol=1e-6)


def test_select_no_decay_on_first_pass():
    # If enough bins pass at the initial threshold, it must not decay
    # (gpet.py:594-595: the first inner pass multiplies by 1.0).
    rng = np.random.RandomState(7)
    M, N = 20, 40
    kde = rng.uniform(0.5, 1.0, (M, N))
    gkde = rng.uniform(0.5, 1.0, (M, N))
    got, thresh, n = _run_select(kde, gkde, [], 0.3, 2, 37, 5,
                                 2, 5, False)
    assert thresh == pytest.approx(0.3)
    assert n >= 5
