"""Multi-device sharding tests on the 8-device virtual CPU mesh
(SURVEY.md §4: the analogue of a fake backend)."""

import gc

import numpy as np
import jax
import jax.numpy as jnp
import pytest


@pytest.fixture(scope="module", autouse=True)
def _fresh_compile_state():
    """Reset JAX's in-process compile state before this module.

    After the full ~160-test prefix of the suite, the XLA:CPU backend
    segfaulted inside ``backend_compile_and_load`` while compiling this
    module's largest multi-device program (2/2 full-suite runs crashed
    at the same test; every shorter-prefix probe — including the first
    99 tests plus the crashing test — passed, so the trigger is
    accumulated in-process compile state, not any specific pairing).
    Dropping the cached executables before the heavy parallel programs
    compile bounds that state at negligible cost: this module's
    programs are new traces that would compile from scratch anyway.
    """
    jax.clear_caches()
    gc.collect()

from gaussian_process_edge_trace_tpu.parallel import (
    make_batch_data, make_batch_state, make_mesh, sharded_trace_batch,
    trace_batch_vmap, trace_multi_edge, trace_sequence)
from gaussian_process_edge_trace_tpu.trace.driver import make_config
from gaussian_process_edge_trace_tpu.utils.image import (
    comp_grad_img, kernel_builder)
from gaussian_process_edge_trace_tpu.utils.metrics import trace_MSE
from gaussian_process_edge_trace_tpu.utils.synthetic import construct_test_img


def _frames(n_frames, size=(64, 64)):
    grads, inits, edges = [], [], []
    for f in range(n_frames):
        img, edge = construct_test_img(
            size=size, amplitude=20, curvature=2, noise_level=0.01,
            ltype="sinusoidal", intensity=0.3, gaps=False, seed=f + 1)
        grad = np.asarray(comp_grad_img(img, kernel_builder((7, 3))),
                          dtype=np.float32)
        N = size[1]
        grads.append(grad)
        inits.append([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
        edges.append(edge[:N])
    return np.stack(grads), np.asarray(inits), np.stack(edges)


def _cfg(shape, n_samples=64, seed=3):
    return make_config(
        np.array([[0, shape[0] // 2], [shape[1] - 1, shape[0] // 2]]),
        shape, kernel_options={"kernel": "RBF", "sigma_f": 20,
                               "length_scale": 7},
        noise_y=1, N_samples=n_samples, score_thresh=0.5, delta_x=5,
        keep_ratio=0.25, pixel_thresh=4, seed=seed, fix_endpoints=True)


def _cfg_for(inits, shape, **kw):
    return make_config(inits[0], shape,
                       kernel_options={"kernel": "RBF", "sigma_f": 20,
                                       "length_scale": 7},
                       noise_y=1, N_samples=kw.pop("n_samples", 64),
                       score_thresh=0.5, delta_x=5, keep_ratio=0.25,
                       pixel_thresh=4, seed=3, fix_endpoints=True, **kw)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_sharded_batch_converges_and_is_accurate():
    grads, inits, edges = _frames(4)
    cfg = _cfg_for(inits, grads.shape[1:])
    data = make_batch_data(cfg, grads, inits)
    states = make_batch_state(cfg, 4)
    mesh = make_mesh(2, 4)
    res = sharded_trace_batch(cfg, data, states, mesh, n_frames=4)
    assert res.edge_trace.shape == (4, cfg.edge_length, 2)
    mses = []
    for f in range(4):
        assert bool(res.converged[f])
        mses.append(float(trace_MSE(
            jnp.asarray(np.asarray(res.edge_trace[f])),
            jnp.asarray(edges[f]))))
    # Tiny 64x64 / 64-sample configs are RNG-variance dominated with a
    # long tail (one mis-selected pixel costs tens of MSE; the
    # single-device path spans the same range). Median must be good, the
    # worst frame merely sane; the tight bound lives in test_driver.py.
    assert float(np.median(mses)) < 30.0, mses
    assert max(mses) < 120.0, mses


# Fields whose values are selected (not accumulated): identical across
# meshes because every posterior draw is keyed by its GLOBAL sample index
# and the whole selection pipeline runs replicated on
# all_gather/psum-assembled values.
_EXACT_FIELDS = ("edge_trace", "n_iters", "converged", "iter_nobs",
                 "iter_thresh", "obs_x", "obs_y", "obs_valid")


@pytest.mark.slow
@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (8, 1)])
def test_sharded_equals_vmap_exactly(mesh_shape):
    """Sharded == single-device vmap: the algorithmic trajectory (every
    accepted pixel, every iteration count, the final integer trace) is
    EXACTLY equal on any mesh, because posterior draws are keyed by global
    sample index and selection runs replicated (gpet.py:839's seed
    determinism extended across meshes). Float telemetry agrees to a few
    f32 ulps — XLA's CPU matmuls may reassociate (E, S/k) vs (E, S)
    contractions."""
    grads, inits, edges = _frames(8)
    cfg = _cfg_for(inits, grads.shape[1:])
    data = make_batch_data(cfg, grads, inits)
    states = make_batch_state(cfg, 8)

    ref = jax.device_get(trace_batch_vmap(cfg, data, states))
    mesh = make_mesh(*mesh_shape)
    got = jax.device_get(
        sharded_trace_batch(cfg, data, states, mesh, n_frames=8))
    assert np.all(np.asarray(ref.converged))
    for field in ref._fields:
        r = np.asarray(getattr(ref, field))
        g = np.asarray(getattr(got, field))
        if field in _EXACT_FIELDS:
            np.testing.assert_array_equal(r, g, err_msg=field)
        else:
            np.testing.assert_allclose(r, g, rtol=1e-4, atol=2e-3,
                                       err_msg=field)


def test_batch_tile_divisor():
    """The tile width depends on the batch size alone — B up to
    _BATCH_TILE, else _BATCH_TILE with the batch padded to a multiple —
    so a data shard can run its frames at the width one device would."""
    from gaussian_process_edge_trace_tpu.parallel.sharded import (
        _BATCH_TILE, _batch_tile)
    assert _BATCH_TILE == 8
    assert _batch_tile(1) == 1
    assert _batch_tile(4) == 4           # fits: no chunking
    assert _batch_tile(8) == 8
    assert _batch_tile(64) == 8          # 8 x 8 tiles
    assert _batch_tile(24) == 8
    assert _batch_tile(20) == 8          # 3 tiles, the last padded
    assert _batch_tile(17) == 8


def test_trace_tiles_pad_and_cut(monkeypatch):
    """_trace_tiles pads the batch with copies of its last frame up to a
    multiple of the tile, traces every tile at that width and returns the
    B real frames in order."""
    from gaussian_process_edge_trace_tpu.parallel import sharded as sh

    seen = []

    def fake_local(cfg, d, st, n_sample_shards, sample_axis):
        seen.append(d.grad_img.shape[0])
        return st

    monkeypatch.setattr(sh, "_trace_local", fake_local)
    B, tile = 5, 2
    data = sh.TracerData(
        grad_img=jnp.arange(B * 3.0).reshape(B, 3),
        grad_kde=jnp.zeros((B, 3)), grad_cols=jnp.zeros((B, 3)),
        L_prior_unit=jnp.zeros((4, 2)), x_grid=jnp.arange(3),
        init_x=jnp.zeros((B, 2), jnp.int32),
        init_y=jnp.zeros((B, 2), jnp.int32))
    states = {"frame": jnp.arange(B), "v": jnp.arange(B * 2.0).reshape(B, 2)}
    out = sh._trace_tiles(None, data, states, tile)
    assert seen == [tile]                # lax.map traces one tile body
    np.testing.assert_array_equal(np.asarray(out["frame"]), np.arange(B))
    np.testing.assert_array_equal(np.asarray(out["v"]),
                                  np.asarray(states["v"]))
    seen.clear()
    out = sh._trace_tiles(None, data, states, 8)     # one padded tile
    assert seen == [8]
    np.testing.assert_array_equal(np.asarray(out["frame"]), np.arange(B))


@pytest.mark.slow
def test_batch_tiling_matches_full_vmap(monkeypatch):
    """Wide batches run as a lax.map over _BATCH_TILE-frame vmap chunks
    (the B=64 serving fix). On the CPU, forcing a tile of 2 on a
    4-frame batch must reproduce the full-width vmap: the algorithmic
    trajectory exactly, float telemetry to reassociation ulps. (On a GPU
    the tile width may move the numerics, which is why sharded runs keep
    the single-device width.)"""
    from gaussian_process_edge_trace_tpu.parallel import sharded as sh

    grads, inits, edges = _frames(4)
    cfg = _cfg_for(inits, grads.shape[1:])
    data = make_batch_data(cfg, grads, inits)
    states = make_batch_state(cfg, 4)
    ref = jax.device_get(trace_batch_vmap(cfg, data, states))

    monkeypatch.setattr(sh, "_BATCH_TILE", 2)
    chunked = jax.jit(trace_batch_vmap.__wrapped__,
                      static_argnames=("cfg",))
    got = jax.device_get(chunked(cfg, data, states))
    for field in ref._fields:
        r = np.asarray(getattr(ref, field))
        g = np.asarray(getattr(got, field))
        if field in _EXACT_FIELDS:
            np.testing.assert_array_equal(r, g, err_msg=field)
        else:
            np.testing.assert_allclose(r, g, rtol=1e-4, atol=2e-3,
                                       err_msg=field)


@pytest.mark.slow
def test_data_axis_only_mesh():
    grads, inits, edges = _frames(8)
    cfg = _cfg_for(inits, grads.shape[1:])
    data = make_batch_data(cfg, grads, inits)
    states = make_batch_state(cfg, 8)
    mesh = make_mesh(8, 1)
    res = sharded_trace_batch(cfg, data, states, mesh, n_frames=8)
    assert np.all(np.asarray(res.converged))


@pytest.mark.slow
def test_trace_multi_edge_one_image():
    """F edges of ONE image in a single dispatch: bitwise-identical to
    the tiled-image batch path, and each edge of a two-boundary image
    traces to its own truth (the reference loops __call__ per edge,
    gpet.py:768; the paper's retinal-layer images are multi-boundary)."""
    size = (96, 96)
    N = size[1]
    img, edge = construct_test_img(
        size=size, amplitude=14, curvature=2, noise_level=0.01,
        ltype="multi-sinusoidal", intensity=0.3, gaps=False, seed=2)
    edges = [edge[:N], edge[N:2 * N]]   # two boundaries, one image
    grad = np.asarray(comp_grad_img(img, kernel_builder((7, 3))),
                      dtype=np.float32)
    inits = np.asarray([[[0, e[0, 0]], [N - 1, e[N - 1, 0]]]
                        for e in edges])
    cfg = _cfg_for(inits, size, n_samples=96)

    res = trace_multi_edge(cfg, jnp.asarray(grad), inits)
    assert res.edge_trace.shape == (2, cfg.edge_length, 2)
    for f, truth in enumerate(edges):
        assert bool(res.converged[f]), f
        mse = float(trace_MSE(jnp.asarray(np.asarray(res.edge_trace[f])),
                              jnp.asarray(truth)))
        assert mse < 60.0, (f, mse)

    # Bitwise parity with the tiled-image batch path.
    tiled = make_batch_data(cfg, np.stack([grad, grad]), inits)
    ref = trace_batch_vmap(cfg, tiled, make_batch_state(cfg, 2))
    for field in ("edge_trace", "n_iters", "converged", "obs_x", "obs_y",
                  "obs_valid"):
        assert np.array_equal(np.asarray(getattr(ref, field)),
                              np.asarray(getattr(res, field))), field


@pytest.mark.slow
def test_trace_ensemble_best_of_k():
    """Best-of-K seed ensembling: member 0 is bitwise the default
    run_trace result, and the returned member is the argmin-final-cost
    one (the cost rank-orders seed quality — measured on the demo
    config, see trace_ensemble docstring)."""
    from gaussian_process_edge_trace_tpu.parallel import trace_ensemble
    from gaussian_process_edge_trace_tpu.trace.driver import (
        init_state, make_data, run_trace)

    grads, inits, edges = _frames(1)
    cfg = _cfg_for(inits, grads.shape[1:])
    data = make_data(cfg, jnp.asarray(grads[0]), jnp.asarray(inits[0]))
    state0 = init_state(cfg)

    best, allres = trace_ensemble(cfg, data, state0, n_seeds=3,
                                  return_all=True)
    costs = np.asarray(allres.final_cost)
    assert costs.shape == (3,)
    assert float(best.final_cost) == float(costs.min())
    k = int(np.argmin(costs))
    np.testing.assert_array_equal(np.asarray(best.edge_trace),
                                  np.asarray(allres.edge_trace[k]))
    # Member 0 == the default single trace, bitwise.
    single = run_trace(cfg, data, state0)
    np.testing.assert_array_equal(np.asarray(allres.edge_trace[0]),
                                  np.asarray(single.edge_trace))
    assert int(allres.n_iters[0]) == int(single.n_iters)


def test_sequence_frame_warm_compaction():
    """The fused sequence frame fits the previous frame's observation
    buffer to the warm-start capacity: over-capacity buffers compact
    valid-first with stable order — identical to the eager host form
    ``xy[valid][:U]`` — and short buffers pad with invalid slots."""
    from gaussian_process_edge_trace_tpu.parallel.sharded import (
        _compact_warm_obs)

    U = 8
    x = jnp.arange(12, dtype=jnp.int32)
    y = 100 + jnp.arange(12, dtype=jnp.int32)
    valid = jnp.asarray([0, 1, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1], bool)
    xy, v = _compact_warm_obs(x, y, valid, U)
    want = np.stack([np.asarray(x)[np.asarray(valid)][:U],
                     np.asarray(y)[np.asarray(valid)][:U]], axis=1)
    np.testing.assert_array_equal(np.asarray(xy), want)
    assert bool(np.all(np.asarray(v)))
    # Under-capacity: pad with invalid slots, originals preserved.
    xy2, v2 = _compact_warm_obs(x[:3], y[:3], valid[:3], U)
    assert xy2.shape == (U, 2) and v2.shape == (U,)
    np.testing.assert_array_equal(np.asarray(xy2[:3, 0]), np.asarray(x[:3]))
    np.testing.assert_array_equal(np.asarray(v2[3:]), False)


@pytest.mark.slow
def test_trace_sequence_warm_start():
    grads, inits, edges = _frames(3)
    cfg = _cfg_for(inits, grads.shape[1:])
    results = trace_sequence(cfg, grads, inits)
    assert len(results) == 3
    mses = []
    for f, res in enumerate(results):
        mses.append(float(trace_MSE(
            jnp.asarray(np.asarray(res.edge_trace)),
            jnp.asarray(edges[f]))))
    # Tiny 64x64 / 64-sample configs are RNG-variance dominated with a
    # long tail (the single-device path spans the same range); the tight
    # accuracy bound lives in test_driver.py.
    assert float(np.median(mses)) < 30.0, mses
    assert max(mses) < 120.0, mses
    # Warm-started frames should not need more iterations than frame 0.
    assert int(results[2].n_iters) <= int(results[0].n_iters) + 1
