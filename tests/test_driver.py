"""End-to-end trace tests on synthetic images (SURVEY.md §4: parity via
trace metrics, determinism via fixed keys)."""

import numpy as np
import jax.numpy as jnp
import pytest

from gaussian_process_edge_trace_tpu.trace.driver import (
    init_state, make_config, make_data, run_trace)
from gaussian_process_edge_trace_tpu.utils.image import (
    comp_grad_img, kernel_builder)
from gaussian_process_edge_trace_tpu.utils.metrics import (
    trace_MSE, trace_dicecoef)
from gaussian_process_edge_trace_tpu.utils.synthetic import construct_test_img


def _demo_setup(size=(128, 128), noise=0.02, delta_x=6):
    img, edge = construct_test_img(
        size=size, amplitude=40, curvature=2, noise_level=noise,
        ltype="sinusoidal", intensity=0.3, gaps=False)
    kernel = kernel_builder(size=(9, 5), unit=False)
    grad = np.asarray(comp_grad_img(img, kernel), dtype=np.float64)
    N = size[1]
    init = np.array([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
    return grad, edge, init, delta_x


def _run(grad, init, delta_x, seed=1, **kw):
    cfg = make_config(
        init, grad.shape, kernel_options={
            "kernel": "RBF", "sigma_f": kw.pop("sigma_f", 30),
            "length_scale": kw.pop("length_scale", 10)},
        noise_y=1, N_samples=kw.pop("N_samples", 200),
        score_thresh=0.5, delta_x=delta_x, keep_ratio=0.1,
        pixel_thresh=5, seed=seed, fix_endpoints=True, **kw)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = init_state(cfg)
    return cfg, run_trace(cfg, data, state0)


@pytest.fixture(scope="module")
def demo_trace():
    grad, edge, init, delta_x = _demo_setup()
    cfg, res = _run(grad, init, delta_x)
    return grad, edge, init, delta_x, cfg, res


def test_trace_converges(demo_trace):
    _, _, _, _, cfg, res = demo_trace
    assert bool(res.converged)
    assert int(res.n_iters) >= 1
    assert int(res.iter_nobs[int(res.n_iters) - 1]) >= cfg.algo_thresh


def test_trace_accuracy(demo_trace):
    grad, edge, _, _, _, res = demo_trace
    pred = np.asarray(res.edge_trace)          # (E, 2) yx
    true = edge[: grad.shape[1]]               # (N, 2) yx
    mse = float(trace_MSE(jnp.asarray(pred), jnp.asarray(true)))
    dice = float(trace_dicecoef(jnp.asarray(pred), jnp.asarray(true)))
    assert mse < 4.0, mse
    assert dice > 0.97, dice


def test_trace_shapes_and_interval(demo_trace):
    _, _, _, _, cfg, res = demo_trace
    E = cfg.edge_length
    assert res.edge_trace.shape == (E, 2)
    assert res.cred_interval.shape == (2, E)
    assert res.cred_interval_px.shape == (2, E)
    # Quirk parity: cred_interval uses standardised-y std (gpet.py:266), so
    # the pixel-unit interval must be at least as wide.
    w_ref = np.asarray(res.cred_interval[1] - res.cred_interval[0])
    w_px = np.asarray(res.cred_interval_px[1] - res.cred_interval_px[0])
    assert np.all(w_px >= w_ref - 1e-6)
    assert np.all(np.isfinite(np.asarray(res.y_mean)))


def test_trace_deterministic(demo_trace):
    grad, _, init, delta_x, _, res1 = demo_trace
    _, res2 = _run(grad, init, delta_x)
    np.testing.assert_array_equal(np.asarray(res1.edge_trace),
                                  np.asarray(res2.edge_trace))
    np.testing.assert_allclose(np.asarray(res1.y_std),
                               np.asarray(res2.y_std))


@pytest.mark.slow
def test_trace_seed_changes_samples_not_quality(demo_trace):
    import jax
    grad, edge, init, delta_x, cfg, _ = demo_trace
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    s0 = init_state(cfg)
    true = jnp.asarray(edge[: grad.shape[1]])
    # Different keys draw different sample paths; the quality distribution
    # is long-tailed on this small config, so assert the median over
    # several keys (runtime keys reuse the compiled program).
    mses = []
    for k in [11, 22, 33, 44, 55]:
        res = run_trace(cfg, data, s0, jax.random.PRNGKey(k))
        mses.append(float(trace_MSE(
            jnp.asarray(np.asarray(res.edge_trace)), true)))
    assert float(np.median(mses)) < 10.0, mses
    assert max(mses) < 80.0, mses


@pytest.mark.slow
def test_warm_start_accepts_user_obs():
    grad, edge, init, delta_x = _demo_setup()
    N = grad.shape[1]
    # Seed a handful of true edge pixels as user observations (xy-space).
    xs = np.arange(10, N - 10, 17)
    user = np.stack([xs, edge[xs, 0]], axis=1)
    cfg = make_config(
        init, grad.shape,
        kernel_options={"kernel": "RBF", "sigma_f": 30, "length_scale": 10},
        noise_y=1, n_user_obs=user.shape[0], N_samples=200,
        score_thresh=0.5, delta_x=delta_x, keep_ratio=0.1, pixel_thresh=5,
        seed=1, fix_endpoints=True)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = init_state(cfg, user_obs_xy=user)
    res = run_trace(cfg, data, state0)
    assert bool(res.converged)
    mse = float(trace_MSE(jnp.asarray(np.asarray(res.edge_trace)),
                          jnp.asarray(edge[:N])))
    assert mse < 4.0, mse


@pytest.mark.slow
def test_matern_kernel_trace():
    grad, edge, init, delta_x = _demo_setup()
    cfg = make_config(
        init, grad.shape,
        kernel_options={"kernel": "Matern", "sigma_f": 30,
                        "length_scale": 10, "nu": 2.5},
        noise_y=1, N_samples=200, score_thresh=0.5, delta_x=delta_x,
        keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    res = run_trace(cfg, data, init_state(cfg))
    assert bool(res.converged)
    mse = float(trace_MSE(jnp.asarray(np.asarray(res.edge_trace)),
                          jnp.asarray(edge[: grad.shape[1]])))
    assert mse < 6.0, mse


@pytest.mark.slow
def test_runtime_key_overrides_seed():
    import jax
    grad, edge, init, delta_x = _demo_setup()
    cfg, res_default = _run(grad, init, delta_x, seed=1)
    from gaussian_process_edge_trace_tpu.trace.driver import (
        init_state as mk_state, make_data as mk_data, run_trace as rt)
    data = mk_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    s0 = mk_state(cfg)
    # Explicit key == PRNGKey(cfg.seed) must reproduce the default path.
    res_k = rt(cfg, data, s0, jax.random.PRNGKey(cfg.seed))
    np.testing.assert_array_equal(np.asarray(res_default.edge_trace),
                                  np.asarray(res_k.edge_trace))
    # A different key draws different samples (same compiled program).
    res_other = rt(cfg, data, s0, jax.random.PRNGKey(12345))
    assert not np.array_equal(np.asarray(res_other.y_mean),
                              np.asarray(res_k.y_mean))


@pytest.mark.slow
def test_free_endpoints_trace():
    # fix_endpoints=False: endpoint columns are eligible for new pixels and
    # the endpoint noise weight is 0.5 (gpet.py:161-162,655-657).
    grad, edge, init, delta_x = _demo_setup()
    cfg = make_config(
        init, grad.shape,
        kernel_options={"kernel": "RBF", "sigma_f": 30, "length_scale": 10},
        noise_y=1, N_samples=200, score_thresh=0.5, delta_x=delta_x,
        keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=False)
    assert cfg.init_noise_weight == 0.5
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    res = run_trace(cfg, data, init_state(cfg))
    assert bool(res.converged)
    mse = float(trace_MSE(jnp.asarray(np.asarray(res.edge_trace)),
                          jnp.asarray(edge[: grad.shape[1]])))
    assert mse < 15.0, mse


@pytest.mark.slow
def test_tuple_kernel_options_trace():
    # The (k, s, l) heuristic (gpet.py:140-151) end to end.
    grad, edge, init, delta_x = _demo_setup()
    cfg = make_config(init, grad.shape, kernel_options=(0, 4, 4),
                      noise_y=1, N_samples=200, score_thresh=0.5,
                      delta_x=delta_x, keep_ratio=0.1, pixel_thresh=5,
                      seed=1, fix_endpoints=True)
    assert cfg.kernel.kind == "RBF"
    assert cfg.sigma_f == 128 // 4   # M // [10,8,6,4,2,1][s-1]
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    res = run_trace(cfg, data, init_state(cfg))
    assert bool(res.converged)


@pytest.mark.slow
def test_multi_sinusoidal_parity_with_reference():
    # Two parallel edges (gpet_utils.py:203-210), endpoints on the fainter
    # first edge. Both the reference algorithm and this framework lock
    # onto the STRONGER second edge (its intensity step is 0.4 vs 0.3, so
    # it dominates the gradient KDE scores) — a behavioural-parity check,
    # verified against benchmarks/reference_cpu.py (err_first 8.5,
    # err_second 1.7 under this exact config).
    img, edge = construct_test_img(
        size=(128, 128), amplitude=40, curvature=2, noise_level=0.01,
        ltype="multi-sinusoidal", intensity=0.3, gaps=False)
    grad = np.asarray(comp_grad_img(img, kernel_builder((9, 5))))
    N = 128
    first = edge[:N]
    second = edge[N:]
    init = np.array([[0, first[0, 0]], [N - 1, first[N - 1, 0]]])
    cfg = make_config(
        init, grad.shape,
        kernel_options={"kernel": "RBF", "sigma_f": 30, "length_scale": 10},
        noise_y=1, N_samples=200, score_thresh=0.5, delta_x=6,
        keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    res = run_trace(cfg, data, init_state(cfg))
    assert bool(res.converged)
    pred = np.asarray(res.edge_trace)
    err_second = np.abs(pred[:, 0] - second[:, 0]).mean()
    assert err_second < 3.0, err_second


@pytest.mark.slow
def test_degenerate_short_edge():
    # Edge span shorter than delta_x: N_subints = 0 so algo_thresh <= 0,
    # the loop body never runs, and the final fit sees only the two inits
    # (the reference would behave the same at gpet.py:829).
    rng = np.random.RandomState(0)
    grad = rng.uniform(0, 1, (32, 32))
    init = np.array([[10, 16], [13, 17]])
    cfg = make_config(init, grad.shape,
                      kernel_options={"kernel": "RBF", "sigma_f": 8,
                                      "length_scale": 3},
                      noise_y=1, N_samples=120, score_thresh=0.5,
                      delta_x=20, keep_ratio=0.25, pixel_thresh=2, seed=0,
                      fix_endpoints=True)
    assert cfg.N_subints == 0
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    res = run_trace(cfg, data, init_state(cfg))
    assert int(res.n_iters) == 0
    assert res.edge_trace.shape == (4, 2)  # edge_length = 13-10+1
    assert np.all(np.isfinite(np.asarray(res.y_mean)))


@pytest.mark.slow
@pytest.mark.parametrize("size", [(96, 256), (256, 96),
                                  (128, 640), (640, 128)])
def test_non_square_trace(size):
    """Any (M, N) image traces end-to-end (the reference accepts arbitrary
    shapes, gpet.py:97). The 640-long shapes cross the per-axis blur gate
    (kde._BLUR_MATMUL_MAX=600): the long axis blurs as shifted FMAs while
    the short one stays a Toeplitz matmul — both orientations exercise the
    (E, M) grad-column vs (M, N) KDE axis handling."""
    grad, edge, init, delta_x = _demo_setup(size=size)
    _, res = _run(grad, init, delta_x,
                  length_scale=max(10, size[1] // 24))
    pred = np.asarray(res.edge_trace)
    true = edge[: size[1]]
    assert bool(res.converged)
    assert pred.shape == (size[1], 2)
    mse = float(trace_MSE(jnp.asarray(pred), jnp.asarray(true)))
    assert mse < 9.0, (size, mse)
    # trace_dicecoef builds an (N, N) mask from the EDGE LENGTH, exactly
    # like the reference (gpet_utils.py:303-307) — on a tall image whose
    # edge rows exceed N columns both masks are empty and the metric is
    # 0/0 = nan in BOTH implementations, so assert it only in its domain.
    if true[:, 0].max() < size[1]:
        dice = float(trace_dicecoef(jnp.asarray(pred), jnp.asarray(true)))
        assert dice > 0.92, (size, dice)


@pytest.mark.slow
def test_unconverged_hits_max_iters():
    # A gradient image with no edge anywhere near the inits: the tracer
    # must stop at max_iters with converged=False instead of looping
    # forever (the reference's latent infinite loop, gpet.py:829).
    rng = np.random.RandomState(1)
    grad = np.zeros((64, 64))
    grad[2, :] = 1.0                       # the only structure, far away
    init = np.array([[0, 60], [63, 60]])
    cfg = make_config(init, grad.shape,
                      kernel_options={"kernel": "RBF", "sigma_f": 4,
                                      "length_scale": 20},
                      noise_y=1, N_samples=120, score_thresh=1.0,
                      delta_x=4, keep_ratio=0.25, pixel_thresh=5, seed=0,
                      fix_endpoints=True, max_iters=4)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    res = run_trace(cfg, data, init_state(cfg))
    assert int(res.n_iters) <= 4
    assert np.all(np.isfinite(np.asarray(res.y_mean)))


@pytest.mark.slow
def test_random_config_fuzz_no_nans():
    """Fuzz: random (size, kernel, hyper, delta_x, keep_ratio, endpoints)
    configs must produce finite outputs with contract-satisfying shapes —
    no NaN escapes, no crash (the reference would raise or loop; here the
    max_iters/max_decays guards bound everything)."""
    rng = np.random.default_rng(0)
    for trial in range(12):
        M = int(rng.integers(40, 140))
        N = int(rng.integers(40, 140))
        amp = int(rng.integers(5, max(6, M // 3)))
        ltype = rng.choice(["sinusoidal", "co-sinusoidal", "straight"])
        img, edge = construct_test_img((M, N), amp, 2, 0.03, str(ltype),
                                       0.3, gaps=bool(rng.integers(2)))
        grad = np.asarray(comp_grad_img(img, kernel_builder((7, 3))))
        init = np.array([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
        kind = rng.choice(["RBF", "Matern"])
        ko = {"kernel": str(kind), "sigma_f": float(rng.uniform(3, M)),
              "length_scale": float(rng.uniform(2, N / 2))}
        if kind == "Matern":
            ko["nu"] = float(rng.choice([1.5, 2.5]))
        cfg = make_config(
            init, grad.shape, kernel_options=ko,
            noise_y=float(rng.uniform(0.2, 3.0)),
            N_samples=int(rng.integers(101, 300)),
            score_thresh=float(rng.uniform(0.2, 1.0)),
            delta_x=int(rng.integers(4, 14)),
            keep_ratio=float(rng.uniform(0.05, 0.5)),
            pixel_thresh=int(rng.integers(2, 6)),
            seed=trial, fix_endpoints=bool(rng.integers(2)),
            max_iters=24)
        data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
        res = run_trace(cfg, data, init_state(cfg))
        assert res.edge_trace.shape == (cfg.edge_length, 2), trial
        assert np.all(np.isfinite(np.asarray(res.y_mean))), trial
        assert np.all(np.isfinite(np.asarray(res.theta))), trial
        tr = np.asarray(res.edge_trace)
        assert np.all((tr[:, 0] >= -M) & (tr[:, 0] <= 2 * M)), trial
        n_it = int(res.n_iters)
        # algo_thresh <= 0 configs legitimately never loop (the
        # reference's while-guard is immediately false too, gpet.py:829).
        assert 0 <= n_it <= cfg.max_iters, trial


@pytest.mark.slow
def test_reference_quirks_off_gives_consistent_posterior():
    """reference_quirks=False disables the fork's posterior-rescale quirk
    (sampling) and the standardised-units credible interval (gpet.py:266):
    cred_interval == cred_interval_px, y_std is pixel-unit, and accuracy
    stays reference-grade."""
    grad, edge, init, delta_x = _demo_setup()
    cfg = make_config(
        init, grad.shape,
        kernel_options={"kernel": "RBF", "sigma_f": 30, "length_scale": 10},
        noise_y=1, N_samples=200, score_thresh=0.5, delta_x=delta_x,
        keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True,
        reference_quirks=False)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    res = run_trace(cfg, data, init_state(cfg))
    assert bool(res.converged)
    np.testing.assert_array_equal(np.asarray(res.cred_interval),
                                  np.asarray(res.cred_interval_px))
    mse = float(trace_MSE(jnp.asarray(np.asarray(res.edge_trace)),
                          jnp.asarray(edge[: grad.shape[1]])))
    assert mse < 8.0, mse
    # Interval must be meaningfully wide in pixel units (the quirk
    # interval is ~y_s times narrower).
    w = np.asarray(res.cred_interval[1] - res.cred_interval[0])
    assert float(np.median(w)) > 0.3, float(np.median(w))


def test_preview_samples_seed0_stream():
    # Parity nit: the reference previews with
    # fit_predict_GP(obs, converged=False, seed=0) (gpet.py:806); the
    # preview's default stream must be the documented seed->PRNGKey(0)
    # mapping, not an ad-hoc fold.
    import jax

    from gaussian_process_edge_trace_tpu.trace.driver import (
        _train_set, preview_samples, sample_round_buffers)

    grad, edge, init, delta_x = _demo_setup()
    cfg, _ = _run(grad, init, delta_x)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state = init_state(cfg)
    got = preview_samples(cfg, data, state)
    x, y, mask, noise_w = _train_set(cfg, data, state)
    want = sample_round_buffers(cfg, data, x, y, mask, noise_w,
                                jax.random.PRNGKey(0))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_legacy_simpson_flag_changes_even_rule_only():
    # even='avg' (historical scipy simps, gpet.py:404-405) must change the
    # cost quadrature's trailing-interval handling and nothing else.
    from gaussian_process_edge_trace_tpu.ops.integrate import (
        simpson_nonuniform, simpson_weights)
    from scipy.integrate import simpson

    rng = np.random.default_rng(3)
    for n in (6, 10, 124):
        x = np.sort(rng.uniform(0, 10, n))
        y = rng.normal(size=n)
        # historical 'avg': mean of (simpson on first n-1 + trapz last)
        # and (trapz first + simpson on last n-1); slices are odd-length
        # so scipy's modern simpson is the unambiguous oracle there.
        first = (simpson(y[:-1], x=x[:-1])
                 + 0.5 * (y[-1] + y[-2]) * (x[-1] - x[-2]))
        second = (0.5 * (y[0] + y[1]) * (x[1] - x[0])
                  + simpson(y[1:], x=x[1:]))
        want = 0.5 * (first + second)
        got = float(simpson_nonuniform(jnp.asarray(y), jnp.asarray(x),
                                       even="avg"))
        np.testing.assert_allclose(got, want, rtol=1e-12)
        w = np.asarray(simpson_weights(jnp.asarray(x), even="avg"))
        np.testing.assert_allclose(y @ w, want, rtol=1e-12)
        # odd-n path unaffected by the flag
        got_odd = float(simpson_nonuniform(jnp.asarray(y[:-1]),
                                           jnp.asarray(x[:-1]),
                                           even="avg"))
        np.testing.assert_allclose(got_odd, simpson(y[:-1], x=x[:-1]),
                                   rtol=1e-12)


@pytest.mark.slow
def test_legacy_simpson_trace_runs():
    grad, edge, init, delta_x = _demo_setup()
    cfg, res = _run(grad, init, delta_x, legacy_simpson=True)
    assert bool(res.converged)
    mse = trace_MSE(np.asarray(res.edge_trace), edge)
    assert mse < 25.0
