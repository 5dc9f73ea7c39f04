"""Aux subsystems: checkpoint/resume, profiling telemetry, chunked KDE
binning."""

import numpy as np
import pytest
import jax.numpy as jnp

from gaussian_process_edge_trace_tpu.trace.checkpoint import (
    load_state, obs_from_result, resume_trace, save_state)
from gaussian_process_edge_trace_tpu.trace.driver import (
    init_state, make_config, make_data, run_trace, trace_step)
from gaussian_process_edge_trace_tpu.trace.kde import column_binning
from gaussian_process_edge_trace_tpu.utils.profiling import (
    PhaseTimer, trace_telemetry)
from gaussian_process_edge_trace_tpu.utils.image import (
    comp_grad_img, kernel_builder)
from gaussian_process_edge_trace_tpu.utils.synthetic import construct_test_img


def _setup(size=(72, 72)):
    img, edge = construct_test_img(size=size, amplitude=22, curvature=2,
                                   noise_level=0.01, ltype="sinusoidal",
                                   intensity=0.3, gaps=False)
    grad = np.asarray(comp_grad_img(img, kernel_builder((7, 3))))
    N = size[1]
    init = np.array([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
    cfg = make_config(
        init, grad.shape,
        kernel_options={"kernel": "RBF", "sigma_f": 20, "length_scale": 7},
        noise_y=1, N_samples=96, score_thresh=0.5, delta_x=5,
        keep_ratio=0.25, pixel_thresh=4, seed=5, fix_endpoints=True)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    return cfg, data, edge


@pytest.mark.slow
def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    cfg, data, _ = _setup()
    state0 = init_state(cfg)
    full = run_trace(cfg, data, state0)

    # Run two iterations, checkpoint, reload, resume.
    state, _ = trace_step(cfg, data, state0)
    state, _ = trace_step(cfg, data, state)
    p = tmp_path / "trace_state.npz"
    save_state(p, state)
    restored = load_state(p)
    for f in state._fields:
        np.testing.assert_array_equal(np.asarray(getattr(state, f)),
                                      np.asarray(getattr(restored, f)))
    resumed = resume_trace(cfg, data, restored)
    np.testing.assert_array_equal(np.asarray(resumed.edge_trace),
                                  np.asarray(full.edge_trace))
    np.testing.assert_allclose(np.asarray(resumed.y_std),
                               np.asarray(full.y_std))


@pytest.mark.slow
def test_obs_from_result_roundtrip_warm_start():
    cfg, data, edge = _setup()
    res = run_trace(cfg, data, init_state(cfg))
    obs = obs_from_result(res)
    assert obs.shape[1] == 2 and obs.shape[0] == int(res.n_iters >= 0) * \
        int(np.asarray(res.obs_valid).sum())
    # Feed them back as a warm start.
    cfg2 = cfg._replace(n_user_obs=obs.shape[0],
                        n_train=cfg.n_train + ((obs.shape[0] + 7) // 8) * 8)
    state2 = init_state(cfg2, user_obs_xy=obs)
    res2 = run_trace(cfg2, data, state2)
    assert bool(res2.converged)
    assert int(res2.n_iters) <= int(res.n_iters)


@pytest.mark.slow
def test_trace_telemetry_dict():
    cfg, data, _ = _setup()
    res = run_trace(cfg, data, init_state(cfg))
    t = trace_telemetry(res)
    n = t["n_iters"]
    assert t["converged"]
    assert t["optimal_costs"].shape == (n,)
    assert t["n_obs"].shape == (n,)
    assert (t["n_obs"] > 0).all()
    assert np.isfinite(t["log_marginal_likelihood"])
    assert t["theta"].shape == (3,)


def test_phase_timer():
    pt = PhaseTimer()
    with pt.phase("a"):
        pass
    with pt.phase("a"):
        pass
    r = pt.report()
    assert r["a"]["calls"] == 2
    assert r["a"]["total_s"] >= 0


def test_chunked_binning_matches_single_block():
    rng = np.random.RandomState(0)
    M, E, S = 30, 25, 700   # forces multiple chunks via monkeypatched size
    import gaussian_process_edge_trace_tpu.trace.kde as kde
    y = jnp.asarray(M / 2 + 10 * rng.standard_normal((E, S)))
    w = jnp.asarray(rng.uniform(0.1, 1.0, S))
    full = column_binning(y, w, M)
    old = kde._CHUNK_ELEMS
    try:
        kde._CHUNK_ELEMS = (M + 2) * E * 64   # chunk size 64 samples
        chunked = column_binning(y, w, M)
    finally:
        kde._CHUNK_ELEMS = old
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(full),
                               rtol=1e-10, atol=1e-12)


def test_checkpoint_with_config_and_fingerprint(tmp_path):
    """save_checkpoint persists the full TracerConfig + data fingerprint;
    load_checkpoint reconstructs the config exactly and refuses a
    mismatched config or different image data."""
    import pytest
    from gaussian_process_edge_trace_tpu.trace.checkpoint import (
        load_checkpoint, save_checkpoint)
    from gaussian_process_edge_trace_tpu.trace.driver import make_data

    cfg, data, _ = _setup()
    state, _ = trace_step(cfg, data, init_state(cfg))
    p = tmp_path / "ckpt.npz"
    save_checkpoint(p, cfg, state, data=data)

    cfg_loaded, state_loaded = load_checkpoint(p, expect_cfg=cfg, data=data)
    assert cfg_loaded == cfg           # exact reconstruction, jit-reusable
    for f in state._fields:
        np.testing.assert_array_equal(np.asarray(getattr(state, f)),
                                      np.asarray(getattr(state_loaded, f)))
    # Resuming with the reconstructed config hits the same compiled
    # program and finishes identically.
    full = run_trace(cfg, data, init_state(cfg))
    resumed = resume_trace(cfg_loaded, data, state_loaded)
    np.testing.assert_array_equal(np.asarray(resumed.edge_trace),
                                  np.asarray(full.edge_trace))

    # Mismatched config refused.
    with pytest.raises(ValueError, match="config mismatch"):
        load_checkpoint(p, expect_cfg=cfg._replace(N_samples=999))
    # Mismatched data refused.
    import jax.numpy as jnp
    # (note: a pure rescale would min-max-normalise back to the same
    # image — square it so the normalised image genuinely differs)
    other = make_data(cfg, jnp.asarray(np.asarray(data.grad_img) ** 2),
                      jnp.stack([data.init_x, data.init_y], axis=1))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        load_checkpoint(p, data=other)


def test_device_op_breakdown_smoke():
    import jax
    import jax.numpy as jnp
    from gaussian_process_edge_trace_tpu.utils.profiling import (
        device_op_breakdown)

    f = jax.jit(lambda x: jnp.sin(x) @ x.T)
    rows = device_op_breakdown(f, jnp.ones((128, 128)), top=5)
    assert rows and all(ms >= 0 for ms, _ in rows)


def test_debug_config_catches_nans():
    # SURVEY §5 sanitizer row: the debug knob turns on
    # jax_debug_nans (FloatingPointError at the producing op) and
    # assert_all_finite validates whole result pytrees.
    import jax
    import jax.numpy as jnp
    import pytest

    from gaussian_process_edge_trace_tpu.utils.debug import (
        assert_all_finite, debug_nans, enable_debug)

    @jax.jit
    def bad(x):
        return jnp.log(x) / jnp.log(x)

    with debug_nans():
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(bad(jnp.asarray(-1.0)))
    assert not jax.config.jax_debug_nans        # restored

    enable_debug(True)
    assert jax.config.jax_debug_nans
    enable_debug(False)

    assert_all_finite({"ok": jnp.ones(3), "n": jnp.arange(3)}, "r")
    with pytest.raises(FloatingPointError, match="bad"):
        assert_all_finite({"bad": jnp.asarray([1.0, jnp.nan])}, "r")
