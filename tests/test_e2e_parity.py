"""End-to-end parity vs the CPU reference implementation.

``benchmarks/reference_cpu.py`` is the reference algorithm re-derived in
NumPy/SciPy (SURVEY.md §4: the demo-config parity test). Stochastic paths
differ (RandomState vs jax.random), so parity is metric-level: both
implementations must converge and reach comparable trace quality on the
same config.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from benchmarks.reference_cpu import ReferenceTracerCPU
from gaussian_process_edge_trace_tpu.trace.driver import (
    init_state, make_config, make_data, run_trace)
from gaussian_process_edge_trace_tpu.utils.image import (
    comp_grad_img, kernel_builder)
from gaussian_process_edge_trace_tpu.utils.metrics import (
    trace_MSE, trace_dicecoef)
from gaussian_process_edge_trace_tpu.utils.synthetic import construct_test_img


@pytest.fixture(scope="module")
def parity_setup():
    img, edge = construct_test_img(
        size=(128, 128), amplitude=40, curvature=2, noise_level=0.03,
        ltype="sinusoidal", intensity=0.3, gaps=False)
    grad = np.asarray(comp_grad_img(img, kernel_builder((9, 5))),
                      dtype=np.float64)
    init = np.array([[0, edge[0, 0]], [127, edge[127, 0]]])
    return grad, edge[:128], init


KW = dict(noise_y=1, N_samples=300, score_thresh=0.5, delta_x=6,
          keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)
KOPT = {"kernel": "RBF", "sigma_f": 30, "length_scale": 10}


@pytest.mark.slow
def test_e2e_parity_with_cpu_reference(parity_setup):
    grad, true_edge, init = parity_setup

    ref = ReferenceTracerCPU(init, grad, KOPT, **KW)
    ref_edge, ref_cred, ref_iters = ref()
    ref_mse = float(trace_MSE(jnp.asarray(ref_edge), jnp.asarray(true_edge)))
    ref_dice = float(trace_dicecoef(jnp.asarray(ref_edge),
                                    jnp.asarray(true_edge)))

    cfg = make_config(init, grad.shape, kernel_options=KOPT, **KW)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    res = run_trace(cfg, data, init_state(cfg))
    jax_mse = float(trace_MSE(jnp.asarray(np.asarray(res.edge_trace)),
                              jnp.asarray(true_edge)))
    jax_dice = float(trace_dicecoef(jnp.asarray(np.asarray(res.edge_trace)),
                                    jnp.asarray(true_edge)))

    assert bool(res.converged)
    assert ref_iters < 48          # the CPU reference also converged
    # Metric parity: both trace the same edge to comparable quality.
    assert ref_dice > 0.95 and jax_dice > 0.95, (ref_dice, jax_dice)
    assert jax_mse < max(4.0 * ref_mse, 25.0), (ref_mse, jax_mse)
    # Iteration counts in the same regime (both ~O(10)).
    assert abs(int(res.n_iters) - ref_iters) <= 6


@pytest.mark.parametrize("ltype", ["sinusoidal", "multi-sinusoidal",
                                   "close multi-sinusoidal",
                                   "co-sinusoidal", "diag", "straight"])
@pytest.mark.slow
def test_all_edge_families_trace(ltype):
    """Every synthetic edge family the reference generates
    (gpet_utils.py:197-235) traces to convergence with sane accuracy."""
    import numpy as np
    import jax.numpy as jnp

    import gaussian_process_edge_trace_tpu as gpt
    from gaussian_process_edge_trace_tpu.trace.driver import (
        init_state, make_config, make_data, run_trace)

    img, edge = gpt.construct_test_img(
        (128, 128), 30, 2, 0.02, ltype, 0.3, gaps=False)
    grad = np.asarray(gpt.comp_grad_img(img, gpt.kernel_builder((7, 3))))
    N = 128
    init = np.array([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
    kernel = ({"kernel": "RBF", "sigma_f": 30, "length_scale": 10}
              if ltype != "close multi-sinusoidal"
              else {"kernel": "Matern", "nu": 1.5, "sigma_f": 30,
                    "length_scale": 6})
    cfg = make_config(init, grad.shape, kernel_options=kernel,
                      noise_y=1, N_samples=256, score_thresh=0.5,
                      delta_x=6, keep_ratio=0.1, pixel_thresh=4, seed=1,
                      fix_endpoints=True)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    res = run_trace(cfg, data, init_state(cfg))
    assert bool(res.converged), ltype
    mse = float(gpt.trace_MSE(np.asarray(res.edge_trace), edge[:N]))
    # Family-dependent difficulty; the bound is a sanity gate, the tight
    # accuracy gate lives on the demo config.
    assert mse < 60.0, (ltype, mse)


def test_gpet_utils_alias_surface():
    """Every public function of the reference's gpet_utils module exists
    on the alias (gpet_utils.py:10-366)."""
    from gaussian_process_edge_trace_tpu import gpet_utils
    for f in ["kernel_builder", "normalise", "comp_grad_img", "denoise",
              "construct_test_img", "trace_MSE", "trace_relarea",
              "trace_dicecoef", "plot_results"]:
        assert hasattr(gpet_utils, f), f


@pytest.mark.slow
def test_credible_interval_coverage():
    """The corrected pixel-unit 95% credible interval actually covers the
    true edge (scientific-calibration check); the reference-quirk interval
    (std left in standardised-y units, gpet.py:266) is pinned as
    near-zero-coverage — the reason TraceResult.cred_interval_px exists."""
    import numpy as np
    import jax.numpy as jnp

    import gaussian_process_edge_trace_tpu as gpt
    from gaussian_process_edge_trace_tpu.trace.driver import (
        init_state, make_config, make_data, run_trace)

    img, edge = gpt.construct_test_img((128, 128), 40, 2, 0.02,
                                       "sinusoidal", 0.3, gaps=False)
    grad = np.asarray(gpt.comp_grad_img(img, gpt.kernel_builder((9, 5))))
    init = np.array([[0, edge[0, 0]], [127, edge[127, 0]]])
    cfg = make_config(init, grad.shape,
                      kernel_options={"kernel": "RBF", "sigma_f": 30,
                                      "length_scale": 10},
                      noise_y=1, N_samples=256, score_thresh=0.5,
                      delta_x=6, keep_ratio=0.1, pixel_thresh=4, seed=1,
                      fix_endpoints=True)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    res = run_trace(cfg, data, init_state(cfg))
    true_y = edge[:128, 0]
    lo, hi = np.asarray(res.cred_interval_px)
    cov_px = float(np.mean((true_y >= lo) & (true_y <= hi)))
    lo2, hi2 = np.asarray(res.cred_interval)
    cov_quirk = float(np.mean((true_y >= lo2) & (true_y <= hi2)))
    # Calibration study (benchmarks/coverage_study.py, r5 — PARITY.md
    # coverage table): at THIS config the 10-seed quirks-off coverage is
    # median 0.82 [0.648, 0.992] and the CPU reference oracle matches
    # (median 0.832, min 0.656) — the shortfall vs the nominal 95% is
    # ALGORITHM-level (function-space-only uncertainty), not ours. The
    # pinned seed measures 0.8125; 0.78 allows only numeric drift, not a
    # calibration regression (was 0.7).
    assert cov_px >= 0.78, cov_px
    assert cov_quirk < cov_px              # the quirk interval is narrower
    assert np.all(hi - lo > 0)


@pytest.mark.slow
def test_credible_interval_coverage_demo():
    """Demo-config (README, 500² gaps) interval calibration: the r5 study
    measured 10-seed coverage median 0.928 [0.87, 0.982] with the CPU
    oracle at 0.942 (min 0.934) — near-nominal on the config users
    actually run. Pinned seed 1 measures 0.982; the 0.85 floor sits below
    the 10-seed minimum so only an implementation-level calibration break
    trips it."""
    import numpy as np
    import jax.numpy as jnp

    import gaussian_process_edge_trace_tpu as gpt
    from gaussian_process_edge_trace_tpu.trace.driver import (
        init_state, make_config, make_data, run_trace)

    img, edge = gpt.construct_test_img((500, 500), 200, 4, 0.05,
                                       "sinusoidal", 0.3, gaps=True)
    grad = np.asarray(gpt.comp_grad_img(img, gpt.kernel_builder(
        (11, 5), unit=False)))
    init = edge[[0, -1]][:, [1, 0]]
    cfg = make_config(init, grad.shape,
                      kernel_options={"kernel": "RBF", "sigma_f": 75,
                                      "length_scale": 20},
                      noise_y=1, N_samples=1000, score_thresh=1,
                      delta_x=5, keep_ratio=0.1, pixel_thresh=5, seed=1,
                      fix_endpoints=True)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    res = run_trace(cfg, data, init_state(cfg))
    true_y = edge[:500, 0]
    lo, hi = np.asarray(res.cred_interval_px)
    cov_px = float(np.mean((true_y >= lo) & (true_y <= hi)))
    assert cov_px >= 0.85, cov_px
