"""API-parity tests for the ``GP_Edge_Tracing`` wrapper class."""

import numpy as np
import pytest
import jax.numpy as jnp

from gaussian_process_edge_trace_tpu import GP_Edge_Tracing
from gaussian_process_edge_trace_tpu.utils.image import (
    comp_grad_img, kernel_builder)
from gaussian_process_edge_trace_tpu.utils.metrics import trace_MSE
from gaussian_process_edge_trace_tpu.utils.synthetic import construct_test_img


def _setup(size=(96, 96)):
    img, edge = construct_test_img(size=size, amplitude=30, curvature=2,
                                   noise_level=0.02, ltype="sinusoidal",
                                   intensity=0.3, gaps=False)
    grad = np.asarray(comp_grad_img(img, kernel_builder((9, 5))))
    N = size[1]
    init = np.array([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
    return grad, edge, init


def _kw():
    return dict(kernel_options={"kernel": "RBF", "sigma_f": 25,
                                "length_scale": 8},
                noise_y=1, N_samples=150, score_thresh=0.5, delta_x=6,
                keep_ratio=0.1, pixel_thresh=5, seed=2, fix_endpoints=True)


@pytest.mark.slow
def test_positional_signature_matches_reference():
    grad, edge, init = _setup()
    # Reference positional order (gpet.py:22-35): init, grad_img,
    # kernel_options, noise_y, obs, N_samples, score_thresh, delta_x,
    # keep_ratio, pixel_thresh, seed, return_std, fix_endpoints.
    tracer = GP_Edge_Tracing(
        init, grad, (1, 3, 3), 1, np.array([], dtype=np.int8), 150, 0.5,
        6, 0.1, 5, 2, False, True)
    out = tracer()
    assert isinstance(out, np.ndarray)
    assert out.shape == (tracer.edge_length, 2)


@pytest.mark.slow
def test_return_std_tuple():
    grad, edge, init = _setup()
    tracer = GP_Edge_Tracing(init, grad, return_std=True, **_kw())
    edge_pred, credint = tracer()
    assert edge_pred.shape == (tracer.edge_length, 2)
    lo, hi = credint
    assert lo.shape == hi.shape == (tracer.edge_length,)
    assert np.all(hi >= lo)
    mse = float(trace_MSE(jnp.asarray(edge_pred),
                          jnp.asarray(edge[: grad.shape[1]])))
    # Small 96x96 config with few observations: one mis-selected pixel can
    # cost ~10 MSE (the reference has the same variance); the tight
    # accuracy bound lives in test_driver.py on the 128x128 config.
    assert mse < 15.0, mse


@pytest.mark.slow
def test_ensemble_kwarg():
    """ensemble=K returns the argmin-final-cost member; its cost is no
    worse than the default single-seed trace (member 0 of the ensemble),
    and the introspective options reject the combination."""
    grad, edge, init = _setup()
    t1 = GP_Edge_Tracing(init, grad, return_std=True, **_kw())
    single = t1()
    cost_single = float(t1.last_result.final_cost)
    t2 = GP_Edge_Tracing(init, grad, return_std=True, **_kw())
    edge_pred, credint = t2(ensemble=3)
    assert edge_pred.shape == single[0].shape
    assert float(t2.last_result.final_cost) <= cost_single + 1e-6
    with pytest.raises(ValueError):
        t2(verbose=True, ensemble=3)


@pytest.mark.slow
def test_return_lines_and_introspective_path_match_fused():
    grad, edge, init = _setup()
    t1 = GP_Edge_Tracing(init, grad, **_kw())
    pred_fused = t1()
    t2 = GP_Edge_Tracing(init, grad, **_kw())
    pred_intro, (all_samples, all_obs, iter_curves) = t2(return_lines=True)
    # Introspective and fused paths run identical jitted numerics.
    np.testing.assert_array_equal(pred_fused, pred_intro)
    # One sample block per iteration plus the final mean.
    n_iter = len(iter_curves) - 1
    assert len(all_samples) == n_iter + 1
    assert len(all_obs) == n_iter + 2  # initial obs + per-iter + final
    assert all_samples[0].shape == (t2.edge_length, t2.N_samples)
    assert iter_curves[-1].shape == (t2.edge_length, 2)


def test_clamps_match_reference():
    grad, edge, init = _setup()
    # N_samples <= 100 -> 1000 (gpet.py:99); delta_x <= 3 -> 2 (gpet.py:105);
    # keep_ratio out of (0,1] -> 0.1; N_keep uses raw args (gpet.py:118).
    tracer = GP_Edge_Tracing(init, grad, N_samples=50, delta_x=3,
                             keep_ratio=1.5, pixel_thresh=1)
    assert tracer.N_samples == 1000
    assert tracer.delta_x == 2
    assert tracer.keep_ratio == 0.1
    assert tracer.pixel_thresh == 2
    assert tracer.N_keep == int(1.5 * 50)
    assert tracer.N_subints == tracer.edge_length // 2
    assert tracer.algo_thresh == tracer.N_subints - 1


@pytest.mark.slow
def test_warm_start_obs_argument():
    grad, edge, init = _setup()
    xs = np.arange(8, 88, 13)
    obs = np.stack([xs, edge[xs, 0]], axis=1)
    tracer = GP_Edge_Tracing(init, grad, obs=obs, **_kw())
    pred = tracer()
    mse = float(trace_MSE(jnp.asarray(pred),
                          jnp.asarray(edge[: grad.shape[1]])))
    # 96x96 config: same long-tailed seed spread as test_return_std_tuple.
    assert mse < 20.0, mse


def test_reference_module_aliases():
    # The reference package layout: `from gp_edge_tracing import gpet,
    # gpet_utils` and the vendored `sklearn_gpr` module.
    from gaussian_process_edge_trace_tpu import gpet, gpet_utils, sklearn_gpr
    assert gpet.GP_Edge_Tracing is GP_Edge_Tracing
    assert hasattr(gpet_utils, "kernel_builder")
    assert hasattr(sklearn_gpr, "GaussianProcessRegressor")
    assert hasattr(sklearn_gpr, "WeightedWhiteKernel")


@pytest.mark.slow
def test_reference_method_surface_drives_one_manual_iteration():
    """Drive the reference's public methods the way gpet.py's __call__
    does (gpet.py:829-886): fit_predict_GP -> get_best_curves ->
    get_best_pixels -> fit_predict_GP(converged=True)."""
    grad, edge, init = _setup()
    tracer = GP_Edge_Tracing(init, grad, **_kw())

    # Sampling round (gpet.py:839): (E, N_samples) posterior curves.
    y_samples = tracer.fit_predict_GP(np.zeros((0, 2), int),
                                      converged=False, seed=1)
    assert y_samples.shape == (tracer.edge_length, tracer.N_samples)

    # Rank curves (gpet.py:847).
    curves, costs, (opt_curve, opt_cost) = tracer.get_best_curves(y_samples)
    assert curves.shape == (tracer.edge_length, tracer.N_keep, 2)
    assert costs.shape == (tracer.N_keep,)
    np.testing.assert_array_equal(curves[:, :, 0],
                                  np.tile(tracer.x_grid[:, None],
                                          (1, tracer.N_keep)))
    assert np.all(np.diff(costs) >= 0) and opt_cost == costs[0]
    np.testing.assert_array_equal(opt_curve, curves[:, 0, :])

    # Curve KDE (gpet.py:648) and gradient KDE (gpet.py:127).
    kde = tracer.kernel_density_estimate(curves, costs)
    assert kde.shape == (tracer.M, tracer.N)
    assert kde.min() == 0.0 and kde.max() == 1.0
    np.testing.assert_allclose(tracer.kernel_density_estimate(),
                               tracer.grad_kde, atol=1e-6)

    # Pixel selection (gpet.py:857, pre_fobs passed yx).
    thresh_before = tracer.score_thresh
    fobs = tracer.get_best_pixels(curves, costs, np.zeros((0, 2), int))
    assert fobs.ndim == 2 and fobs.shape[1] == 2 and fobs.shape[0] > 0
    assert tracer.score_thresh <= thresh_before  # persistent decay
    # fobs is xy: x within image, one per bin => strictly increasing x.
    assert np.all(np.diff(fobs[:, 0]) > 0)
    assert np.all((fobs[:, 0] >= 0) & (fobs[:, 0] < tracer.N))

    # compute_new_obs with explicit yx candidates (gpet.py:532-619).
    cand_yx = np.argwhere(kde > tracer.kde_thresh)
    cand_yx = cand_yx[(cand_yx[:, 1] > tracer.x_st)
                      & (cand_yx[:, 1] < tracer.x_en)]
    fobs2 = tracer.compute_new_obs(cand_yx, kde, fobs[:, [1, 0]])
    assert fobs2.shape[1] == 2 and fobs2.shape[0] >= fobs.shape[0]

    # Drive the remaining rounds through the methods exactly as the
    # reference __call__ does (gpet.py:829-861) until convergence.
    it = 1
    while fobs.shape[0] < tracer.algo_thresh and it < tracer.cfg.max_iters:
        it += 1
        y_samples = tracer.fit_predict_GP(fobs, converged=False, seed=it)
        curves, costs, _ = tracer.get_best_curves(y_samples)
        fobs = tracer.get_best_pixels(curves, costs, fobs[:, [1, 0]])
    assert fobs.shape[0] >= tracer.algo_thresh

    # Converged fit (gpet.py:874): mean + standardised-units std.
    y_mean, y_std = tracer.fit_predict_GP(fobs, converged=True, seed=2)
    assert y_mean.shape == y_std.shape == (tracer.edge_length,)
    assert np.all(y_std >= 0)
    mse = float(np.mean((y_mean - edge[: tracer.edge_length, 0]) ** 2))
    assert mse < 40.0, mse


def test_cost_funct_matches_scipy_oracle():
    """tracer.cost_funct on an arbitrary (non-grid) edge vs the reference
    formula computed with scipy directly (gpet.py:391-408)."""
    import scipy.integrate
    from scipy.interpolate import RectBivariateSpline

    grad, edge, init = _setup()
    tracer = GP_Edge_Tracing(init, grad, **_kw())
    rng = np.random.default_rng(0)
    xs = np.sort(rng.uniform(0, tracer.N - 1, size=60))
    ys = np.clip(edge[np.clip(xs.astype(int), 0, tracer.N - 1), 0]
                 + rng.normal(0, 2.0, size=60), 0, tracer.M - 1)
    e = np.stack([xs, ys], axis=1)

    interp = RectBivariateSpline(np.arange(tracer.M), np.arange(tracer.N),
                                 tracer.grad_img, kx=1, ky=1)
    es = e[e[:, 0].argsort(), :]
    gs = interp(es[:, 1], es[:, 0], grid=False) + tracer.kde_thresh
    pixel_diff = np.cumsum(np.sqrt(np.sum(np.diff(es, axis=0) ** 2, axis=1)))
    deriv = es[1:, 1] - es[:-1, 1]
    integrand = np.sqrt(1 + deriv ** 2)
    ref_cost = (scipy.integrate.simpson(integrand, x=es[:-1, 0])
                / scipy.integrate.simpson(gs[:-1], x=pixel_diff))
    got = tracer.cost_funct(e)
    np.testing.assert_allclose(got, ref_cost, rtol=1e-6)


def test_grad_interp_and_finite_diff_methods():
    from scipy.interpolate import RectBivariateSpline

    grad, edge, init = _setup()
    tracer = GP_Edge_Tracing(init, grad, **_kw())
    interp = RectBivariateSpline(np.arange(tracer.M), np.arange(tracer.N),
                                 tracer.grad_img, kx=1, ky=1)
    rng = np.random.default_rng(1)
    rows = rng.uniform(-2, tracer.M + 1, 50)   # incl. out-of-domain clamp
    cols = rng.uniform(-2, tracer.N + 1, 50)
    np.testing.assert_allclose(tracer.grad_interp(rows, cols, grid=False),
                               interp(rows, cols, grid=False), atol=1e-6)
    v = rng.normal(size=17)
    np.testing.assert_allclose(tracer.finite_diff(v, typ=0, h=1),
                               v[1:] - v[:-1], atol=1e-12)


def test_plot_methods_smoke():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grad, edge, init = _setup()
    tracer = GP_Edge_Tracing(init, grad, **_kw())
    y_samples = tracer.fit_predict_GP(np.zeros((0, 2), int),
                                      converged=False, seed=1)
    curves, costs, (opt_curve, opt_cost) = tracer.get_best_curves(y_samples)
    from gaussian_process_edge_trace_tpu.utils import plotting
    fig1 = plotting.plot_iter(tracer.x_grid, y_samples, 10,
                              np.zeros((0, 2), int), tracer.init,
                              (tracer.M, tracer.N), show=False)
    fig2 = plotting.plot_diagnostics(tracer.grad_img, tracer.x_grid,
                                     [opt_curve], [opt_cost], show=False)
    assert fig1 is not None and fig2 is not None
    plt.close("all")


def test_X_tile_is_lazy():
    # constructing the tracer must not allocate the
    # O(E*S) tiled X mirror (800 MB at BASELINE config-4 scale); it
    # materialises only on attribute access (gpet.py:115 parity).
    grad, edge, init = _setup()
    kw = _kw()
    kw["N_samples"] = 100_000
    tracer = GP_Edge_Tracing(init, grad, **kw)
    assert tracer._X is None
    X = tracer.X
    assert X.shape == (tracer.edge_length, tracer.N_samples)
    assert (X[:, 0] == tracer.x_grid).all()
    assert tracer._X is X  # cached
