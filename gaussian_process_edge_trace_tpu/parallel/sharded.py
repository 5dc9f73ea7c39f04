"""Multi-device tracing: data-parallel frames × sample-parallel draws.

The reference is strictly single-image, single-process (SURVEY.md §2:
"Parallelism / distributed components: NONE"). This framework makes the
two data-parallel axes it leaves on the table first-class:

- **dp ("data" axis)**: independent frames/edges sharded across devices —
  each device runs complete traces for its shard of the batch
  (BASELINE.json config 5's batched-frames case);
- **sp ("sample" axis)**: the N_samples posterior draws of *one* trace
  split across devices — Matheron draws, curve costs and KDE binning are
  computed on local sample shards, stitched with one ``all_gather`` of the
  cost vector (global top-N_keep) and one ``psum`` that assembles the kept
  curves per iteration (BASELINE.json config 4's N_samples→10⁵ case).

Both axes ride ``jax.shard_map`` over a ``Mesh``; XLA hands the
collectives to NCCL. On a host whose GPUs are joined all to all by NVLink
every pair of cards talks at the same rate, so the mesh is shaped by the
algorithm alone. There is no tensor/pipeline parallelism to build: the
largest model state is an (n_obs × n_obs) Gram of a few hundred rows
(SURVEY.md §2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from gaussian_process_edge_trace_tpu.trace.driver import (
    TraceResult, TracerConfig, TracerData, TraceState, _iteration,
    _round_up, finish_trace, frame_arrays, init_state, make_data,
    prior_factor)

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


def make_mesh(n_data: int, n_sample: int,
              devices=None) -> Mesh:
    """A (data, sample) device mesh. ``n_data * n_sample`` must equal the
    device count used."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    assert devices.size == n_data * n_sample, (devices.size, n_data, n_sample)
    return Mesh(devices.reshape(n_data, n_sample),
                axis_names=(DATA_AXIS, SAMPLE_AXIS))


def make_batch_data(cfg: TracerConfig, grad_imgs, inits) -> TracerData:
    """Per-frame :class:`TracerData` with a leading frame axis on the
    image-dependent leaves; the prior factor and x-grid depend only on the
    (shared) config and stay unbatched."""
    grad_imgs = jnp.asarray(grad_imgs)
    inits = jnp.asarray(inits)
    g, gkde, gcols, ix, iy = jax.vmap(
        lambda gr, i: frame_arrays(cfg, gr, i))(grad_imgs, inits)
    L_unit, x_grid = prior_factor(cfg)
    return TracerData(grad_img=g, grad_kde=gkde, grad_cols=gcols,
                      L_prior_unit=L_unit, x_grid=x_grid, init_x=ix,
                      init_y=iy)


def _sorted_edge_inits(inits):
    """Per-edge init sort by x (gpet.py:95), batched: (F, n, 2) ->
    ((F, n) init_x, (F, n) init_y)."""
    inits = jnp.asarray(inits, jnp.int32)
    if inits.ndim != 3:
        raise ValueError("inits must be (F, n_inits, 2); got shape "
                         f"{inits.shape}")
    order = jnp.argsort(inits[:, :, 0], axis=1)
    s = jnp.take_along_axis(inits, order[:, :, None], axis=1)
    return s[..., 0], s[..., 1]


@functools.partial(jax.jit, static_argnames=("cfg",))
def _multi_edge_fused(cfg, grad_img, inits, L_unit, x_grid,
                      user_obs_xy=None):
    """The whole multi-edge program in ONE dispatch: per-image
    preprocessing (computed once, shared across the edge vmap via
    ``in_axes=None`` — one device copy, no broadcast, unlike a tiled
    :func:`make_batch_data`), per-edge init sorting, fresh states, and
    all F traces. An eager version paid ~5 host round trips per call
    for frame_arrays / init sorting / state assembly before the jitted
    trace — the same lesson as :func:`_sequence_frame`."""
    g, gkde, gcols, _, _ = frame_arrays(cfg, grad_img, inits[0])
    ixs, iys = _sorted_edge_inits(inits)

    def one(ix, iy, uobs):
        state = init_state(cfg, user_obs_xy=uobs)
        return _one_trace(cfg, g, gkde, gcols, L_unit, x_grid, ix, iy,
                          state)

    if user_obs_xy is None:
        return jax.vmap(lambda ix, iy: one(ix, iy, None))(ixs, iys)
    return jax.vmap(one)(ixs, iys, user_obs_xy)


@functools.partial(jax.jit, static_argnames=("cfg", "n_seeds",
                                              "return_all"))
def trace_ensemble(cfg: TracerConfig, data: TracerData,
                   state0: TraceState, n_seeds: int = 5,
                   return_all: bool = False):
    """Best-of-``n_seeds`` trace in ONE dispatch, selected by the
    algorithm's own final cost.

    The recursive-Bayesian tracer is long-tailed across RNG seeds (demo
    10-seed DICE spread 0.9912-0.9974), and the reference's cost
    (gpet.py:408 — arc length over line integral of the final mean
    curve) rank-orders that quality essentially perfectly: on the demo
    config the measured final-cost ordering 4.42 → 5.35 tracks DICE
    0.9972 → 0.9912 monotonically. Running K complete traces vmapped
    over per-member keys (member k uses ``PRNGKey(cfg.seed + k)``, so
    member 0 IS the default :func:`..trace.driver.run_trace` result) and
    keeping the argmin-cost member clips the tail at K× device compute,
    amortised into a single dispatch — a serving mode the reference's
    one-trace-per-call loop (gpet.py:768) cannot express.

    Returns the best member's :class:`TraceResult` (with ``return_all``,
    a ``(best, all_results)`` pair — ``all_results`` leaves carry a
    leading ``n_seeds`` axis).
    """
    from gaussian_process_edge_trace_tpu.trace.driver import run_trace

    if n_seeds < 1:
        raise ValueError(f"n_seeds must be >= 1, got {n_seeds}")
    keys = jnp.stack([jax.random.PRNGKey(cfg.seed + k)
                      for k in range(n_seeds)])
    results = jax.vmap(
        lambda key: run_trace(cfg, data, state0, key=key))(keys)
    # NaN costs (a degenerate member's final fit) must lose, not win:
    # jnp.argmin follows numpy and returns the NaN index.
    costs = results.final_cost
    best = jnp.argmin(jnp.where(jnp.isnan(costs), jnp.inf, costs))
    chosen = jax.tree.map(lambda a: a[best], results)
    return (chosen, results) if return_all else chosen


def trace_multi_edge(cfg: TracerConfig, grad_img, inits,
                     user_obs_xy=None) -> TraceResult:
    """Trace F edges of ONE image in a single fused dispatch.

    The reference traces one edge per ``__call__`` (gpet.py:768) — its
    multi-boundary deployments (the paper's retinal-layer images,
    README.md:8-16) loop over edges, re-running the per-image
    preprocessing each time. Here the image-dependent arrays (normalised
    gradient, gradient KDE, interp columns) are computed once and SHARED
    across the edge vmap (``in_axes=None`` — one device copy, where
    :func:`make_batch_data` on a tiled image holds F). Numerically
    identical to F separate :func:`..trace.driver.run_trace` calls with
    the same config. ``user_obs_xy`` (optional, (F, U, 2)) warm-starts
    each edge exactly like the reference's ``obs`` argument
    (gpet.py:57-61).

    Args:
      grad_img: (M, N) gradient image, shared by every edge.
      inits: (F, n_inits, 2) per-edge init points in xy-space.
    """
    inits = jnp.asarray(inits, jnp.int32)
    if inits.ndim != 3:
        raise ValueError("inits must be (F, n_inits, 2); got shape "
                         f"{inits.shape}")
    L_unit, x_grid = prior_factor(cfg)
    if user_obs_xy is not None:
        user_obs_xy = jnp.asarray(user_obs_xy, jnp.int32)
    return _multi_edge_fused(cfg, jnp.asarray(grad_img), inits, L_unit,
                             x_grid, user_obs_xy)


def make_batch_state(cfg: TracerConfig, n_frames: int,
                     user_obs_xy=None) -> TraceState:
    """Stacked initial states for ``n_frames`` traces.

    ``user_obs_xy`` may be ``None`` or an (F, U, 2) warm-start array (e.g.
    the previous frame's accepted pixels, gpet.py:57-61)."""
    if user_obs_xy is None:
        s = init_state(cfg)
        return jax.tree.map(
            lambda a: jnp.broadcast_to(a, (n_frames,) + a.shape), s)
    user_obs_xy = jnp.asarray(user_obs_xy, jnp.int32)
    states = [init_state(cfg, user_obs_xy=user_obs_xy[f])
              for f in range(n_frames)]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


def _sharded_single_trace(cfg: TracerConfig, data: TracerData,
                          state0: TraceState, n_sample_shards: int,
                          sample_axis) -> TraceResult:
    """One full trace, optionally sample-sharded over ``sample_axis``."""
    key = jax.random.PRNGKey(cfg.seed)
    # Loop-invariant blur factors, hoisted out of the while body (see
    # kde.blur_matrices; bitwise-identical ops). The barrier stops XLA
    # rematerialising the build back into the loop body (run_trace A/B:
    # without it the build re-ran every iteration, ~0.09 ms/trace).
    from gaussian_process_edge_trace_tpu.trace.kde import blur_matrices
    blur = blur_matrices(cfg.M, cfg.N, data.grad_kde.dtype)
    if blur is not None:
        blur = jax.lax.optimization_barrier(blur)

    def cond(s):
        return (s.n_fobs < cfg.algo_thresh) & (s.it < cfg.max_iters)

    def body(s):
        new_state, _ = _iteration(cfg, data, key, s,
                                  sample_axis=sample_axis,
                                  n_sample_shards=n_sample_shards,
                                  blur=blur)
        return new_state

    state = jax.lax.while_loop(cond, body, state0)
    return finish_trace(cfg, data, state)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "mesh", "n_frames"))
def sharded_trace_batch(cfg: TracerConfig, data: TracerData,
                        states0: TraceState, mesh: Mesh,
                        n_frames: int) -> TraceResult:
    """Trace ``n_frames`` independent frames on a (data, sample) mesh.

    Frames are sharded over the data axis; within each frame the
    N_samples posterior draws are sharded over the sample axis.
    ``n_frames`` must divide by the data-axis size and ``cfg.N_samples``
    by the sample-axis size. Each shard traces its frames at the vmap
    width :func:`trace_batch_vmap` uses for all ``n_frames`` (padding with
    copies of its last frame), so the result equals that function's on
    one device exactly: same accepted pixels, iterations and trace.
    """
    n_data = mesh.shape[DATA_AXIS]
    n_sample = mesh.shape[SAMPLE_AXIS]
    assert n_frames % n_data == 0, (n_frames, n_data)
    assert cfg.N_samples % n_sample == 0, (cfg.N_samples, n_sample)

    frame_sharded = P(DATA_AXIS)
    data_specs = TracerData(
        grad_img=frame_sharded, grad_kde=frame_sharded,
        grad_cols=frame_sharded, L_prior_unit=P(), x_grid=P(),
        init_x=frame_sharded, init_y=frame_sharded)
    state_specs = jax.tree.map(lambda _: frame_sharded, states0)
    out_specs = TraceResult(
        *([frame_sharded] * len(TraceResult._fields)))

    def local_fn(data_local, states_local):
        # Static varying-manifest typing (check_vma=True): the while-loop
        # body mixes the replicated carry with collective-produced
        # (sample-axis-varying-typed) values, so the whole carry must
        # enter the loop varying-typed; the outputs are restored to
        # sample-invariant with an idempotent pmax (every sample-axis
        # member holds IDENTICAL results by construction — posterior
        # draws are keyed by global sample index and the per-iteration
        # all_gather/psum replicate the selection inputs — so pmax is a
        # no-op on values and only a type cast + tiny end-of-trace
        # collective; the (1,8)/(2,4)/(8,1) trajectory-parity tests pin
        # the invariant dynamically as well).
        states_local = jax.tree.map(
            lambda a: jax.lax.pcast(a, (SAMPLE_AXIS,), to="varying"),
            states_local)
        # The local frames run at the tile width one device would use for
        # the whole batch, padded if the shard holds fewer frames.
        res = _trace_tiles(cfg, data_local, states_local,
                           _batch_tile(n_frames), n_sample, SAMPLE_AXIS)
        return jax.tree.map(_sample_invariant, res)

    def _sample_invariant(a):
        if a.dtype == jnp.bool_:
            return jax.lax.pmax(a.astype(jnp.int8),
                                SAMPLE_AXIS).astype(jnp.bool_)
        return jax.lax.pmax(a, SAMPLE_AXIS)

    return jax.shard_map(
        local_fn, mesh=mesh, in_specs=(data_specs, state_specs),
        out_specs=out_specs, check_vma=True)(data, states0)


def _one_trace(cfg, g, gkde, gcols, L_unit, x_grid, ix, iy, state,
               n_sample_shards=1, sample_axis=None):
    """One complete trace from explicit data leaves — the shared vmap
    body of the batch (per-frame leaves) and multi-edge (shared-image
    leaves) serving paths."""
    d = TracerData(grad_img=g, grad_kde=gkde, grad_cols=gcols,
                   L_prior_unit=L_unit, x_grid=x_grid,
                   init_x=ix, init_y=iy)
    return _sharded_single_trace(cfg, d, state, n_sample_shards,
                                 sample_axis)


def _trace_local(cfg, data_local, states_local, n_sample_shards,
                 sample_axis=None):
    """vmap complete traces over this device's local frames."""
    def one(grad, gkde, gcols, ix, iy, state):
        return _one_trace(cfg, grad, gkde, gcols, data_local.L_prior_unit,
                          data_local.x_grid, ix, iy, state,
                          n_sample_shards, sample_axis)
    return jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0))(
        data_local.grad_img, data_local.grad_kde, data_local.grad_cols,
        data_local.init_x, data_local.init_y, states_local)


# Maximum vmap width of one batch tile. Tiling the batch into lax.map
# chunks keeps the vmapped while-loop program at a bounded width (wide
# vmaps grew per-frame cost in layout copies, pads and slices around the
# while carry) AND cuts the lockstep-straggler cost: each chunk's
# while_loop stops at the chunk's own max iteration count instead of the
# global batch maximum. The width 8 was tuned on the previous accelerator
# and is not yet swept on the H100 (ROADMAP C5).
_BATCH_TILE = 8


def _batch_tile(B: int) -> int:
    """vmap width of one tile for a batch of ``B`` frames: ``B`` itself up
    to ``_BATCH_TILE``, else ``_BATCH_TILE`` (the batch is padded to a
    multiple of it)."""
    return min(B, _BATCH_TILE)


def _trace_tiles(cfg, data, states0, tile, n_sample_shards=1,
                 sample_axis=None):
    """Trace the frames of ``data``/``states0`` as vmaps of exactly
    ``tile`` frames: padded with copies of the last frame up to a multiple
    of ``tile``, run as one vmap or a ``lax.map`` over tiles, and cut back.

    The width is what keeps results equal between devices: on a GPU the
    batched Cholesky, solves and matmuls of the sampling rounds and the
    final fit pick their kernels by batch size, so a frame traced at
    another vmap width can end on another θ and, past a near-tie, another
    trace. Each shard of :func:`sharded_trace_batch` therefore runs its
    frames at the width one device uses for the whole batch.
    """
    B = data.grad_img.shape[0]
    n_tiles = -(-B // tile)
    pad = n_tiles * tile - B

    def tiled(a):
        if pad:
            a = jnp.concatenate(
                [a, jnp.broadcast_to(a[-1:], (pad,) + a.shape[1:])])
        return a.reshape((n_tiles, tile) + a.shape[1:])

    frames = ((tiled(data.grad_img), tiled(data.grad_kde),
               tiled(data.grad_cols), tiled(data.init_x),
               tiled(data.init_y)),
              jax.tree.map(tiled, states0))

    def one_tile(args):
        (g, gkde, gcols, ix, iy), st = args
        d = TracerData(grad_img=g, grad_kde=gkde, grad_cols=gcols,
                       L_prior_unit=data.L_prior_unit,
                       x_grid=data.x_grid, init_x=ix, init_y=iy)
        return _trace_local(cfg, d, st, n_sample_shards, sample_axis)

    if n_tiles == 1:
        res = one_tile(jax.tree.map(lambda a: a[0], frames))
        return jax.tree.map(lambda a: a[:B], res)
    res = jax.lax.map(one_tile, frames)
    return jax.tree.map(lambda a: a.reshape((n_tiles * tile,)
                                            + a.shape[2:])[:B], res)


@functools.partial(jax.jit, static_argnames=("cfg",))
def trace_batch_vmap(cfg: TracerConfig, data: TracerData,
                     states0: TraceState) -> TraceResult:
    """Single-device batched tracing — the dp-only fallback, the numerical
    oracle for the sharded path, and the single-chip serving workhorse
    (B complete traces amortise one dispatch round trip).

    Batches wider than ``_BATCH_TILE`` are tiled: ONE dispatch whose body
    is a ``lax.map`` over tiles of ``_BATCH_TILE`` vmapped frames, the
    last one padded (see ``_BATCH_TILE`` and :func:`_trace_tiles`). On the
    CPU per-frame results do not depend on the tile width; on a GPU they
    may, by f32 rounding, which is why the sharded path matches this
    function's width rather than its own.

    Module-level jit with a static ``cfg``: an earlier version built the
    jit wrapper inside the function body, which made EVERY call retrace
    and recompile.
    """
    B = states0.it.shape[0]
    return _trace_tiles(cfg, data, states0, _batch_tile(B))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _sequence_frame(cfg: TracerConfig, grad_img, init_xy, L_unit, x_grid,
                    user_x, user_y, user_valid) -> TraceResult:
    """One fully-fused sequence frame: per-frame preprocessing, warm-start
    state assembly and the complete trace in a SINGLE dispatch, so the
    frame-to-frame handoff never leaves the device (the eager version
    cost ~5 host round trips/frame: make_data, per-leaf ``device_get``,
    warm-obs re-upload)."""
    from gaussian_process_edge_trace_tpu.trace.driver import run_trace

    g, gkde, gcols, ix, iy = frame_arrays(cfg, grad_img, init_xy)
    data = TracerData(grad_img=g, grad_kde=gkde, grad_cols=gcols,
                      L_prior_unit=L_unit, x_grid=x_grid, init_x=ix,
                      init_y=iy)
    xy, valid = _compact_warm_obs(user_x, user_y, user_valid,
                                  cfg.n_user_obs)
    state = init_state(cfg, user_obs_xy=xy, user_obs_valid=valid)
    return run_trace(cfg, data, state)


def _compact_warm_obs(user_x, user_y, user_valid, U: int):
    """Fit a warm-start observation buffer to capacity ``U``: when the
    previous frame's (U+B,) buffer exceeds it, compact valid entries to
    the front (stable — preserves bin order, identical to the eager
    version's boolean-index-then-truncate ``xy[valid][:U]``) and keep the
    first U; shorter buffers are zero-padded with invalid slots."""
    user_x = user_x.astype(jnp.int32)
    user_y = user_y.astype(jnp.int32)
    user_valid = user_valid.astype(bool)
    if user_x.shape[0] > U:
        order = jnp.argsort(~user_valid, stable=True)[:U]
        user_x, user_y = user_x[order], user_y[order]
        user_valid = user_valid[order]
    pad = U - user_x.shape[0]
    xy = jnp.stack([jnp.pad(user_x, (0, pad)),
                    jnp.pad(user_y, (0, pad))], axis=1)
    return xy, jnp.pad(user_valid, (0, pad))


def trace_sequence(cfg: TracerConfig, grad_imgs, inits):
    """Sequentially trace an image sequence, warm-starting each frame from
    the previous frame's accepted observations (BASELINE.json config 5;
    the reference's ``obs`` propagation mechanism, gpet.py:57-61).

    Sequential in time by construction (each frame consumes the previous
    frame's result) — but entirely on-device: each frame is one fused
    dispatch consuming the previous frame's observation buffers directly
    (bin-slot order with validity mask; the GP is mask/permutation
    invariant, so this matches the compacted-prefix form up to float
    reassociation), and results are fetched once at the end. Independent
    sequences batch via :func:`sharded_trace_batch`.
    """
    # Warm-started frames share ONE fixed-capacity config (user-obs slots
    # padded to the bin count + mask) so every frame after the first hits
    # the same compiled executable.
    u_cap = _round_up(cfg.bins.n_bins, 8)
    cfg_warm = cfg._replace(
        n_user_obs=u_cap,
        n_train=_round_up(cfg.n_inits + u_cap + cfg.bins.n_bins, 8))
    cfg_cold = cfg._replace(
        n_user_obs=0,
        n_train=_round_up(cfg.n_inits + cfg.bins.n_bins, 8))
    L_unit, x_grid = prior_factor(cfg_cold)

    # ONE bulk upload for all frames (not a host round trip per frame),
    # then the dispatch chain, then ONE bulk fetch.
    grad_dev, init_dev = jax.device_put(
        (list(np.asarray(g) for g in grad_imgs),
         list(np.asarray(i) for i in inits)))
    results = []
    prev = None
    empty = jnp.zeros((0,), jnp.int32)
    for f in range(len(grad_imgs)):
        if prev is None:
            res = _sequence_frame(cfg_cold, grad_dev[f], init_dev[f],
                                  L_unit, x_grid,
                                  empty, empty, empty.astype(bool))
        else:
            res = _sequence_frame(cfg_warm, grad_dev[f], init_dev[f],
                                  L_unit, x_grid,
                                  prev.obs_x, prev.obs_y, prev.obs_valid)
        results.append(res)
        prev = res
    return jax.device_get(results)
