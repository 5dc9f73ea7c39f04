"""The recursive-Bayesian edge-trace driver.

JAX re-design of ``GP_Edge_Tracing`` (reference: gpet.py:17-908).
The reference's mutate-as-you-go object loop becomes a functional pipeline
over fixed-shape padded buffers, so an entire trace — every GP fit, the
posterior sampling, curve scoring, KDE, pixel selection, and the final
LML-optimised fit — compiles to ONE XLA program (:func:`run_trace`).

Structure:

- :class:`TracerConfig` — frozen static configuration (hashable, a jit
  static argument). Mirrors the reference ``__init__`` defaults and
  clamping semantics (gpet.py:95-119).
- :class:`TracerData` — device arrays precomputed once per (config, image):
  normalised gradient image, gradient KDE (gpet.py:127), and the
  unit-variance prior Cholesky over all image columns that powers
  Matheron pathwise sampling (O(N³) once instead of an O(E³)
  factorisation per iteration, cf. sklearn_gpr.py:464).
- :class:`TraceState` — the while-loop carry: a per-bin observation buffer
  (one slot per sub-interval over the full image width — the padded
  equivalent of "one accepted pixel per occupied bin"), a user-supplied
  warm-start observation buffer that participates in the first iteration
  only (exactly the reference's lifecycle: user obs train the first GP and
  are rescored once, then are replaced by the binned selection,
  gpet.py:820,857), the persistent adaptive score threshold
  (gpet.py:595), and fixed-capacity telemetry buffers.
- :func:`run_trace` — ``lax.while_loop`` of :func:`_iteration` followed by
  :func:`_final_fit`, all jitted together.

Deviations from the reference (all documented, all behaviour-preserving in
the metric sense):

- per-iteration RNG is ``fold_in(key(seed), it+1)`` mirroring
  ``seed+N_iter+1`` (gpet.py:839); bitwise sample parity with
  ``np.random.RandomState.multivariate_normal`` is impossible, the
  contract is statistical parity (SURVEY.md §7 "stochastic parity");
- training points are not sorted by x (gpet.py:212-214): the GP posterior
  is permutation-invariant, so sorting is dead work;
- a ``max_iters`` guard bounds the outer loop (the reference can loop
  forever if no new bins appear, gpet.py:829);
- the final credible interval preserves the reference quirk of leaving the
  predictive std in standardised-y units (gpet.py:266 rescales the mean
  but not the std); ``TraceResult.cred_interval_px`` also exposes the
  corrected pixel-unit interval.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_process_edge_trace_tpu.models.gpr import (
    batched_lml, fit_and_sample, gp_fit, gp_predict, masked_mean, masked_std)
from gaussian_process_edge_trace_tpu.models.kernels import (
    KernelSpec, resolve_kernel_options)
from gaussian_process_edge_trace_tpu.trace.kde import (blur_matrices,
                                                       curve_kde,
                                                       gradient_kde)
from gaussian_process_edge_trace_tpu.trace.scoring import (
    best_curves, curve_costs)
from gaussian_process_edge_trace_tpu.trace.select import (
    BinSpec, make_bin_spec, select_pixels)
from gaussian_process_edge_trace_tpu.utils.image import normalise

# Relative eigenvalue threshold AND tail-variance budget (as a fraction of
# trace(K) ≈ N) for the truncated prior factor — see prior_factor().
_PRIOR_RANK_RTOL = 1e-8


class TracerConfig(NamedTuple):
    """Static trace configuration (all fields hashable Python scalars)."""
    M: int
    N: int
    x_st: int
    x_en: int
    edge_length: int
    kernel: KernelSpec
    sigma_f: float
    sigma_l: float
    noise_y: float
    N_samples: int
    N_keep: int
    delta_x: int
    N_subints: int
    pixel_thresh: int
    algo_thresh: int
    score_thresh0: float
    kde_thresh: float
    fix_endpoints: bool
    n_inits: int
    n_user_obs: int
    bins: BinSpec
    n_train: int          # padded training capacity (multiple of 8)
    seed: int
    max_iters: int
    max_decays: int
    lml_restarts: int
    init_noise_weight: float  # 1e-7 if fix_endpoints else 0.5 (gpet.py:161)
    gp_jitter: float          # GPR alpha (gpet.py:155)
    # True (default) reproduces the reference fork's posterior-rescale
    # quirk (sampling rounds scale the centred posterior by std/(std+1),
    # sklearn_gpr.py:227 vs :385,401) and its standardised-units credible
    # interval (gpet.py:266). False gives the mathematically consistent
    # posterior: unit post-scale and a pixel-unit 95% interval.
    reference_quirks: bool = True
    # True reproduces the historical scipy `simps` even='avg' rule the
    # upstream's cost quadratures used (gpet.py:404-405); False (default)
    # is the modern Cartwright rule, matching the installed scipy and the
    # CPU parity oracle. The two differ by one trailing-interval term.
    legacy_simpson: bool = False


class TracerData(NamedTuple):
    """Per-(config, image) device arrays, computed once."""
    grad_img: jnp.ndarray      # (M, N) normalised gradient image
    grad_kde: jnp.ndarray      # (M, N) gradient KDE (gpet.py:127)
    grad_cols: jnp.ndarray     # (E, M) grad_img.T sliced to the x-grid —
    #                            loop-invariant interp operand
    L_prior_unit: jnp.ndarray  # (N, N) unit prior Cholesky over all columns
    x_grid: jnp.ndarray        # (E,) int32 output columns
    init_x: jnp.ndarray        # (n_inits,) int32
    init_y: jnp.ndarray        # (n_inits,) int32


class TraceState(NamedTuple):
    obs_x: jnp.ndarray        # (B,) int32 per-bin observation buffer
    obs_y: jnp.ndarray        # (B,) int32
    obs_valid: jnp.ndarray    # (B,) bool
    user_x: jnp.ndarray       # (U,) int32 warm-start observations
    user_y: jnp.ndarray       # (U,) int32
    user_valid: jnp.ndarray   # (U,) bool — cleared after the 1st iteration
    score_thresh: jnp.ndarray  # scalar, persistent adaptive threshold
    n_fobs: jnp.ndarray       # scalar int32
    it: jnp.ndarray           # scalar int32
    # telemetry (fixed capacity max_iters)
    iter_curves: jnp.ndarray  # (max_iters, E) optimal curve per iteration
    iter_costs: jnp.ndarray   # (max_iters,)
    iter_nobs: jnp.ndarray    # (max_iters,) int32
    iter_thresh: jnp.ndarray  # (max_iters,)


class TraceResult(NamedTuple):
    edge_trace: jnp.ndarray        # (E, 2) int32, yx-space (gpet.py:886)
    y_mean: jnp.ndarray            # (E,) posterior mean, pixel units
    y_std: jnp.ndarray             # (E,) predictive std — standardised-y
    #                                units, the reference quirk (gpet.py:266)
    cred_interval: jnp.ndarray     # (2, E) mean ∓ 1.96·y_std (gpet.py:876)
    cred_interval_px: jnp.ndarray  # (2, E) corrected, pixel units
    n_iters: jnp.ndarray           # scalar int32
    converged: jnp.ndarray         # scalar bool (False = max_iters hit)
    theta: jnp.ndarray             # (3,) optimised (log c, log ℓ, log σn²)
    lml: jnp.ndarray               # scalar optimised log marginal likelihood
    final_cost: jnp.ndarray        # cost of the final mean curve (gpet.py:890)
    iter_curves: jnp.ndarray       # (max_iters, E)
    iter_costs: jnp.ndarray        # (max_iters,)
    iter_nobs: jnp.ndarray         # (max_iters,) int32
    iter_thresh: jnp.ndarray       # (max_iters,)
    obs_x: jnp.ndarray             # (U+B,) the final accepted observation
    obs_y: jnp.ndarray             #        set (user warm-start ∪ binned),
    obs_valid: jnp.ndarray         #        i.e. what the final fit used


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def make_config(init, grad_img_shape, kernel_options=(1, 3, 3), noise_y=1,
                n_user_obs=0, N_samples=500, score_thresh=1, delta_x=20,
                keep_ratio=0.1, pixel_thresh=5, seed=42,
                fix_endpoints=True, max_iters=48, max_decays=400,
                lml_restarts=12, reference_quirks=True,
                legacy_simpson=False) -> TracerConfig:
    """Build a :class:`TracerConfig` with the reference's clamping semantics
    (gpet.py:95-119). ``init`` is the (n, 2) xy-space endpoint array."""
    init = np.asarray(init)
    init_sorted = init[np.argsort(init[:, 0])].astype(int)
    # gpet.py:96 reads x_st/x_en from the *unsorted* input; an unsorted
    # input breaks the reference (empty x_grid), so we use the sorted one.
    x_st, x_en = int(init_sorted[0, 0]), int(init_sorted[-1, 0])
    M, N = grad_img_shape

    n_samples_c = int(N_samples) if N_samples > 100 else 1000  # gpet.py:99
    keep_ratio_c = float(keep_ratio) if 0 < keep_ratio <= 1 else 0.1
    pixel_thresh_c = int(pixel_thresh) if pixel_thresh >= 2 else 2
    score_thresh_c = float(score_thresh) if 0 < score_thresh <= 1 else 1.0
    delta_x_c = int(delta_x) if delta_x > 3 else 2             # gpet.py:105

    edge_length = x_en - x_st + 1
    N_subints = int(edge_length // delta_x_c)
    # N_keep uses the *raw* arguments, not the clamped ones (gpet.py:118).
    N_keep = int(keep_ratio * N_samples)
    algo_thresh = N_subints - (pixel_thresh_c - 1)             # gpet.py:119

    spec, sigma_f, sigma_l = resolve_kernel_options(
        kernel_options, M, edge_length)
    bins = make_bin_spec(N, x_st, x_en, delta_x_c)
    n_inits = init_sorted.shape[0]
    n_train = _round_up(n_inits + int(n_user_obs) + bins.n_bins, 8)

    return TracerConfig(
        M=M, N=N, x_st=x_st, x_en=x_en, edge_length=edge_length,
        kernel=spec, sigma_f=sigma_f, sigma_l=sigma_l,
        noise_y=float(noise_y), N_samples=n_samples_c, N_keep=N_keep,
        delta_x=delta_x_c, N_subints=N_subints,
        pixel_thresh=pixel_thresh_c, algo_thresh=algo_thresh,
        score_thresh0=score_thresh_c, kde_thresh=1e-3,
        fix_endpoints=bool(fix_endpoints), n_inits=n_inits,
        n_user_obs=int(n_user_obs), bins=bins, n_train=n_train,
        seed=int(seed), max_iters=int(max_iters),
        max_decays=int(max_decays), lml_restarts=int(lml_restarts),
        init_noise_weight=[0.5, 1e-7][int(bool(fix_endpoints))],
        gp_jitter=1e-6, reference_quirks=bool(reference_quirks),
        legacy_simpson=bool(legacy_simpson))


@functools.partial(jax.jit, static_argnames=("cfg",))
def frame_arrays(cfg: TracerConfig, grad_img, init_xy):
    """Per-frame arrays (gpet.py:97,127): normalised gradient image,
    gradient KDE, interp column matrix, sorted init points. vmap-able over
    a frame batch."""
    g = normalise(grad_img, (0, 1), jnp.float32)
    gkde = gradient_kde(g, kde_thresh=cfg.kde_thresh)
    gcols = jax.lax.dynamic_slice(
        g.T, (cfg.x_st, 0), (cfg.edge_length, cfg.M))
    init_xy = jnp.asarray(init_xy, jnp.int32)
    order = jnp.argsort(init_xy[:, 0])
    init_xy = init_xy[order]
    return g, gkde, gcols, init_xy[:, 0], init_xy[:, 1]


@functools.lru_cache(maxsize=16)
def prior_factor(cfg: TracerConfig):
    """Config-only precompute (one per config, shared by all frames): the
    unit prior factor over all image columns and the output x-grid.

    Computed on the host in float64 — the symmetric eigendecomposition of
    an (N, N) Gram takes well under a second in LAPACK at N=1000, it runs
    exactly once per config, and f64 gives a cleaner square root of the
    numerically rank-deficient prior (same robustness rationale as
    sklearn_gpr.py:464 sampling via SVD). Cached per config.

    The factor is TRUNCATED to the prior's numerical rank: the RBF /
    Matérn Gram's eigenvalues decay (super-)exponentially onto the
    ``gp_jitter`` PSD-guard floor, so eigenpairs with
    ``w_i ≤ max(2·gp_jitter, w_max · _PRIOR_RANK_RTOL)`` carry no model
    content (the jitter was never part of the kernel — it exists only to
    keep the factorisation PSD) and are dropped, yielding an (N, r)
    factor with r ≈ 40–80 at the production configs, which cuts the
    per-iteration prior-draw matmul ``F @ z`` and its threefry normals by
    ~N/r ≈ 20× at N=1000. Discarded variance bound: rows of V are
    orthonormal, so the per-point truncated variance is ≤ the threshold
    itself (≈ 2e-6 in unit-kernel scale ⇒ std ≤ 1.5e-3, ~0.3 px at the
    demo's σf, worst case; the average is ~3e-4) — two orders below the
    algorithm's own seed spread, verified by the e2e accuracy gates. Set
    ``GPET_FULL_RANK_PRIOR=1`` (before first use — the factor is cached)
    to keep the exact full-rank factor for A/Bs."""
    import os

    from gaussian_process_edge_trace_tpu.models.kernels import k_unit_np
    cols = np.arange(cfg.N, dtype=np.float64)
    d = np.abs(cols[:, None] - cols[None, :]) / cfg.sigma_l
    K = k_unit_np(cfg.kernel, d)
    K[np.diag_indices_from(K)] += cfg.gp_jitter
    w, V = np.linalg.eigh(K)                  # ascending
    w = np.clip(w, 0.0, None)
    if not os.environ.get("GPET_FULL_RANK_PRIOR"):
        thr = max(2.0 * cfg.gp_jitter, w[-1] * _PRIOR_RANK_RTOL)
        r = int(np.sum(w > thr))
        r = min(cfg.N, ((r + 7) // 8) * 8)    # round the rank up to 8
        w, V = w[cfg.N - r:], V[:, cfg.N - r:]
    F = V * np.sqrt(w)[None, :]
    x_grid = cfg.x_st + jnp.arange(cfg.edge_length, dtype=jnp.int32)
    return jnp.asarray(F, jnp.float32), x_grid


def make_data(cfg: TracerConfig, grad_img, init_xy) -> TracerData:
    """Precompute the per-image device arrays (gpet.py:97,122-127)."""
    g, gkde, gcols, ix, iy = frame_arrays(cfg, grad_img, init_xy)
    L_unit, x_grid = prior_factor(cfg)
    return TracerData(grad_img=g, grad_kde=gkde, grad_cols=gcols,
                      L_prior_unit=L_unit, x_grid=x_grid, init_x=ix,
                      init_y=iy)


def init_state(cfg: TracerConfig, user_obs_xy=None,
               user_obs_valid=None) -> TraceState:
    """Initial loop state; ``user_obs_xy`` is the warm-start (U, 2) xy
    observation array (gpet.py:57-61,820). ``user_obs_valid`` optionally
    masks padded warm-start slots (so frame sequences can share one
    fixed-capacity config and avoid per-frame recompilation)."""
    B = cfg.bins.n_bins
    U = cfg.n_user_obs
    if user_obs_xy is None:
        user_obs_xy = jnp.zeros((0, 2), jnp.int32)
    user_obs_xy = jnp.asarray(user_obs_xy, jnp.int32).reshape(-1, 2)
    assert user_obs_xy.shape[0] == U, (user_obs_xy.shape, U)
    E = cfg.edge_length
    mi = cfg.max_iters
    return TraceState(
        obs_x=jnp.zeros((B,), jnp.int32), obs_y=jnp.zeros((B,), jnp.int32),
        obs_valid=jnp.zeros((B,), bool),
        user_x=user_obs_xy[:, 0], user_y=user_obs_xy[:, 1],
        user_valid=(jnp.ones((U,), bool) if user_obs_valid is None
                    else jnp.asarray(user_obs_valid, bool)),
        score_thresh=jnp.asarray(cfg.score_thresh0, jnp.float32),
        n_fobs=(jnp.asarray(U, jnp.int32) if user_obs_valid is None
                else jnp.sum(jnp.asarray(user_obs_valid, bool),
                             dtype=jnp.int32)),
        it=jnp.asarray(0, jnp.int32),
        iter_curves=jnp.zeros((mi, E), jnp.float32),
        iter_costs=jnp.zeros((mi,), jnp.float32),
        iter_nobs=jnp.zeros((mi,), jnp.int32),
        iter_thresh=jnp.zeros((mi,), jnp.float32))


def _train_set(cfg: TracerConfig, data: TracerData, state: TraceState):
    """Assemble the padded training buffers: init + user obs + binned obs
    (gpet.py:209-214; sorting elided — the GP is permutation-invariant)."""
    pad = cfg.n_train - cfg.n_inits - cfg.n_user_obs - cfg.bins.n_bins
    x = jnp.concatenate([data.init_x, state.user_x, state.obs_x,
                         jnp.zeros((pad,), jnp.int32)])
    y = jnp.concatenate([data.init_y, state.user_y, state.obs_y,
                         jnp.zeros((pad,), jnp.int32)])
    mask = jnp.concatenate([jnp.ones((cfg.n_inits,), bool),
                            state.user_valid, state.obs_valid,
                            jnp.zeros((pad,), bool)])
    # Endpoint noise weight 1e-7/0.5, observation weight 1 (gpet.py:161,209).
    noise_w = jnp.concatenate([
        jnp.full((cfg.n_inits,), cfg.init_noise_weight, jnp.float32),
        jnp.ones((cfg.n_train - cfg.n_inits,), jnp.float32)])
    return x, y, mask, noise_w


def _sample_round(cfg: TracerConfig, data: TracerData, x, y, mask, noise_w,
                  key, n_samples=None, sample_offset=0):
    """One sampling-mode GP round (gpet.py:227-230,255-261): scale y by
    std+1, set variance to σf²/y_s², fit + draw N_samples Matheron curves,
    rescale."""
    yf = y.astype(jnp.float32)
    std_raw = masked_std(yf, mask)
    y_s = std_raw + 1.0
    variance = (cfg.sigma_f ** 2) / (y_s ** 2)
    diag_noise = cfg.noise_y * noise_w + cfg.gp_jitter
    # Reference-fork quirk (sklearn_gpr.py:227 vs :385,401): predict
    # multiplies the centred posterior by std(y_scaled) that fit never
    # divided out, so the effective pixel-space posterior deviation is
    # scaled by std_raw/(std_raw+1). _handle_zeros_in_scale maps a zero
    # std to 1 (sklearn_gpr.py:223).
    s2 = std_raw / y_s
    post_scale = jnp.where(s2 == 0.0, 1.0, s2)
    if not cfg.reference_quirks:
        post_scale = 1.0          # mathematically consistent posterior
    samples = fit_and_sample(
        key, cfg.kernel, x.astype(jnp.float32), yf / y_s, cfg.sigma_l,
        variance, diag_noise, mask, data.L_prior_unit, x_idx=x,
        grid_out=data.x_grid,
        n_samples=cfg.N_samples if n_samples is None else n_samples,
        centre=True, post_scale=post_scale, sample_offset=sample_offset,
        total_samples=None if n_samples is None else cfg.N_samples)
    return samples * y_s  # (E, S)


def _iteration(cfg: TracerConfig, data: TracerData, key, state: TraceState,
               sample_axis: Optional[str] = None, n_sample_shards: int = 1,
               blur=None):
    """One outer-loop iteration (gpet.py:829-861).

    With ``sample_axis`` set (inside :func:`shard_map` over a mesh axis of
    size ``n_sample_shards``), each shard draws its N_samples/k slice of
    the posterior curves — columns of the full keyed draw, so each sample
    consumes the identical random stream a single device would use — and
    scores them locally; the global top-N_keep selection runs replicated
    on an ``all_gather`` of the (tiny) cost vector, the kept curves are
    assembled with a local clamped take + in-range mask + ``psum`` (every column has
    exactly one contributing shard, the rest add exact zeros), and the
    KDE over the kept set is computed replicated. The selection pipeline
    therefore executes the identical computation on every shard, and the
    only per-sample work, the draw and the cost, gives each sample the same
    bits whatever the shard's width: on the CPU by XLA's own kernels, on a
    GPU by the two kernels built for it (ops/posterior_draw.py,
    ops/fused_cost.py). ``sharded_trace_batch`` on any mesh therefore
    reproduces ``trace_batch_vmap``'s algorithmic trajectory EXACTLY
    (same accepted pixels, same iteration counts, same integer trace),
    pinned on (1,8), (2,4), (8,1) CPU meshes in tests/test_parallel.py and
    on (1,4), (2,2), (4,1) GPU meshes by ``chip_smoke.py --devices 4``.
    """
    x, y, mask, noise_w = _train_set(cfg, data, state)
    key_it = jax.random.fold_in(key, state.it + 1)  # seed+N_iter+1
    s_local = cfg.N_samples // n_sample_shards
    off = (0 if sample_axis is None
           else jax.lax.axis_index(sample_axis) * s_local)
    samples = _sample_round(cfg, data, x, y, mask, noise_w, key_it,
                            n_samples=s_local, sample_offset=off)

    costs = curve_costs(
        data.grad_img, data.x_grid, samples,
        kde_thresh=cfg.kde_thresh, cols=data.grad_cols,
        even="avg" if cfg.legacy_simpson else "simpson")
    if sample_axis is None:
        bc, bcosts = best_curves(samples, costs, cfg.N_keep)
    else:
        costs_g = jax.lax.all_gather(costs, sample_axis,
                                     tiled=True)          # (S,) global
        neg, idx = jax.lax.top_k(-costs_g, cfg.N_keep)
        bcosts = -neg
        # Local slice of the global selection: column k lives on exactly
        # one shard — gather it there (clamped take + in-range mask), add
        # exact zeros elsewhere, psum. Bitwise the single-device
        # best_curves() output.
        lidx = idx - off
        in_range = (lidx >= 0) & (lidx < s_local)
        taken = jnp.take(samples, jnp.clip(lidx, 0, s_local - 1), axis=1)
        bc = jax.lax.psum(
            jnp.where(in_range[None, :], taken, 0.0),
            sample_axis)                                  # (E, N_keep)
    inv = 1.0 / bcosts
    weights = inv / jnp.sum(inv)                          # gpet.py:492-493
    kde_arr = curve_kde(bc, weights, cfg.M, cfg.N, cfg.x_st, blur=blur)
    opt_curve, opt_cost = bc[:, 0], bcosts[0]

    # Previous observations = user warm-start ∪ binned buffer.
    prev_x = jnp.concatenate([state.user_x, state.obs_x])
    prev_y = jnp.concatenate([state.user_y, state.obs_y])
    prev_valid = jnp.concatenate([state.user_valid, state.obs_valid])
    sel = select_pixels(
        kde_arr, data.grad_kde, prev_x, prev_y, prev_valid,
        n_pre=state.n_fobs, score_thresh=state.score_thresh, spec=cfg.bins,
        fix_endpoints=cfg.fix_endpoints, kde_thresh=cfg.kde_thresh,
        pixel_thresh=cfg.pixel_thresh, algo_thresh=cfg.algo_thresh,
        max_decays=cfg.max_decays)

    i = state.it
    new_state = TraceState(
        obs_x=sel.obs_x, obs_y=sel.obs_y, obs_valid=sel.obs_valid,
        user_x=state.user_x, user_y=state.user_y,
        user_valid=jnp.zeros_like(state.user_valid),  # first-iter only
        score_thresh=sel.score_thresh, n_fobs=sel.n_fobs, it=i + 1,
        iter_curves=state.iter_curves.at[i].set(opt_curve),
        iter_costs=state.iter_costs.at[i].set(opt_cost),
        iter_nobs=state.iter_nobs.at[i].set(sel.n_fobs),
        iter_thresh=state.iter_thresh.at[i].set(sel.score_thresh))
    return new_state, samples


def _final_fit(cfg: TracerConfig, data: TracerData, key, state: TraceState):
    """Converged fit: standardise, maximise LML with 1+`lml_restarts`
    vmapped L-BFGS starts, predict (gpet.py:233-248,263-266 →
    sklearn_gpr.py:254-295)."""
    x, y, mask, noise_w = _train_set(cfg, data, state)
    return _final_fit_buffers(cfg, data, key, x, y, mask, noise_w)


def optimize_lml(kernel: KernelSpec, xs, ys, mask, noise_w, starts, lb, ub,
                 jitter=1e-6, n_polish=8, polish_iters=6):
    """Maximise the LML over θ = (log c, log ℓ, log σn²) within [lb, ub].

    The reference runs scipy L-BFGS-B to convergence from all 13 starts
    (sklearn_gpr.py:266-288); every objective evaluation here is a
    latency-bound Gram+Cholesky chain, so sequential depth is traded for
    width: ONE batched screen of the 13 starts ∪ a static grid over the
    box (global search), then a short damped-Newton polish of the
    ``n_polish`` best (:mod:`..models.newton`) — 2 batched objective units
    per iteration. Matches converged scipy from the same starts with zero
    optimum gaps across random configs (tests/test_gpr.py property test).
    Six polish iterations, not fewer: on the demo's final fits in f32,
    four stopped 0.003–0.011 LML units short of converged scipy and six
    came within 5e-5 (PERF.md).
    Every objective batch is one
    :func:`..models.gpr.batched_lml` call (analytic trace-formula
    gradients, FD Hessian), which on the H100 beat autodiff through
    ``log_marginal_likelihood`` 3× at n=104 and 5× at n=408.
    Returns ``(theta, lml)``.
    """
    from gaussian_process_edge_trace_tpu.models.newton import (
        lml_screen_grid, screen_and_polish)

    allstarts = jnp.concatenate(
        [starts, lml_screen_grid(lb, ub, starts.dtype)])

    def _fns(xs_, ys_, mask_, nw_):
        def values_fn(th):
            return -batched_lml(kernel, xs_, ys_, mask_, th, nw_,
                                jitter=jitter)

        def vg_fn(th):
            v, g = batched_lml(kernel, xs_, ys_, mask_, th, nw_,
                               jitter=jitter, with_grad=True)
            return -v, -g
        return values_fn, vg_fn

    values_fn, vg_fn = _fns(xs, ys, mask, noise_w)
    if xs.shape[0] <= 160:
        res = screen_and_polish(values_fn, vg_fn, allstarts, lb, ub,
                                n_polish=n_polish, iters=polish_iters)
        return res.x, -res.f
    # Large n: coarse-to-fine. Screen AND polish on a stride-subsampled
    # training set (n ≤ 112, so the whole global search costs about a
    # demo-scale fit), then re-polish the coarse optimum at full n from 2
    # starts. Polishing all n_polish basins at full n is both slower and
    # WORSE: at n=408 the full-n top-8 polish left a 70-LML-unit gap vs
    # converged scipy where this path lands within 2e-2 — the cheap
    # subsampled polish converges every candidate basin before the
    # expensive full-n refinement. The n=160 switch point was set on the
    # previous accelerator and is not yet swept on the H100 (ROADMAP C5).
    stride = -(-xs.shape[0] // 112)
    vs_sub, vg_sub = _fns(xs[::stride], ys[::stride], mask[::stride],
                          noise_w[::stride])
    coarse = screen_and_polish(vs_sub, vg_sub, allstarts, lb, ub,
                               n_polish=n_polish, iters=polish_iters)
    # The coarse optimum starts ~2e-2 LML units from the full-n optimum
    # and damped Newton converges quadratically, so polish_iters-1 fine
    # iterations land inside the 1e-3 scipy-gap tolerance (property-
    # tested at n=208/408).
    fine_starts = jnp.stack([coarse.x, starts[0]])
    res = screen_and_polish(values_fn, vg_fn, fine_starts, lb, ub,
                            n_polish=2, iters=max(polish_iters - 1, 2))
    return res.x, -res.f


def _final_fit_buffers(cfg: TracerConfig, data: TracerData, key, x, y, mask,
                       noise_w):
    """:func:`_final_fit` body on explicit padded training buffers (also
    drives the public ``fit_predict_GP(converged=True)`` tracer method,
    gpet.py:233-248)."""
    xf = x.astype(jnp.float32)
    yf = y.astype(jnp.float32)
    X_m, X_s = masked_mean(xf, mask), masked_std(xf, mask)
    y_m, y_s = masked_mean(yf, mask), masked_std(yf, mask)
    # Zero-std guard (degenerate training sets, e.g. algo_thresh <= 0
    # configs that skip the loop and fit only two equal-y endpoints):
    # the reference's manual standardisation divides by np.std unguarded
    # (gpet.py:237 — NaN there); map 0 -> 1 like sklearn's
    # _handle_zeros_in_scale. PARITY.md documents the deviation.
    X_s = jnp.where(X_s == 0.0, 1.0, X_s)
    y_s = jnp.where(y_s == 0.0, 1.0, y_s)
    xs = jnp.where(mask, (xf - X_m) / X_s, 0.0)
    ys = jnp.where(mask, (yf - y_m) / y_s, 0.0)

    # θ = (log c, log ℓ, log σn²); bounds gpet.py:246-248.
    lb = jnp.log(jnp.asarray([0.01, 0.1, 1e-18], jnp.float32))
    ub = jnp.log(jnp.asarray([1e3, 100.0, 1.0], jnp.float32))
    theta0 = jnp.log(jnp.asarray([5.0, 5.0, cfg.noise_y], jnp.float32))
    theta0 = jnp.clip(theta0, lb, ub)
    restarts = jax.random.uniform(
        key, (cfg.lml_restarts, 3), jnp.float32) * (ub - lb) + lb
    starts = jnp.concatenate([theta0[None], restarts], axis=0)

    theta, lml = optimize_lml(cfg.kernel, xs, ys, mask, noise_w, starts,
                              lb, ub, jitter=cfg.gp_jitter)

    c = jnp.exp(theta[0])
    ls = jnp.exp(theta[1])
    noise = jnp.exp(theta[2])
    gp = gp_fit(cfg.kernel, xs, ys, ls, c,
                noise * noise_w + cfg.gp_jitter, mask, centre=False)
    xq = (data.x_grid.astype(jnp.float32) - X_m) / X_s
    mean_std, std = gp_predict(cfg.kernel, gp, xq, ls, c, return_std=True)
    y_mean = y_s * mean_std + y_m            # gpet.py:266
    return y_mean, std, y_s, theta, lml


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples"))
def sample_round_buffers(cfg: TracerConfig, data: TracerData, x, y, mask,
                         noise_w, key, n_samples=None):
    """Public jitted wrapper of the sampling-mode GP round on explicit
    padded buffers — backs ``GP_Edge_Tracing.fit_predict_GP(converged=
    False)`` (gpet.py:182-261) for arbitrary observation sets."""
    return _sample_round(cfg, data, x, y, mask, noise_w, key,
                         n_samples=n_samples)


@functools.partial(jax.jit, static_argnames=("cfg",))
def final_fit_buffers(cfg: TracerConfig, data: TracerData, x, y, mask,
                      noise_w, key):
    """Public jitted wrapper of the converged LML fit on explicit padded
    buffers — backs ``GP_Edge_Tracing.fit_predict_GP(converged=True)``
    (gpet.py:233-266). Returns ``(y_mean, y_std)`` (standardised-units
    std, the reference quirk)."""
    y_mean, y_std, _, _, _ = _final_fit_buffers(cfg, data, key, x, y, mask,
                                                noise_w)
    return y_mean, y_std


@functools.partial(jax.jit, static_argnames=("cfg",))
def finish_trace(cfg: TracerConfig, data: TracerData,
                 state: TraceState, key=None) -> TraceResult:
    """Post-loop finalisation: converged LML fit, credible interval, yx
    trace, final-cost telemetry (gpet.py:874-890).

    ``key`` (optional runtime PRNG key) defaults to ``PRNGKey(cfg.seed)``;
    passing it explicitly reruns with another seed without recompiling."""
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    key_final = jax.random.fold_in(key, 0)   # seed+N_iter analogue
    y_mean, y_std_s, y_s, theta, lml = _final_fit(cfg, data, key_final,
                                                  state)

    # Reference quirk: the interval (and y_std) keep the standardised-y
    # std (gpet.py:266). With reference_quirks=False both are pixel-unit.
    y_std_px = y_s * y_std_s
    y_std = y_std_s if cfg.reference_quirks else y_std_px
    cred = jnp.stack([y_mean - 1.96 * y_std, y_mean + 1.96 * y_std])
    cred_px = jnp.stack([y_mean - 1.96 * y_std_px,
                         y_mean + 1.96 * y_std_px])
    edge_trace = jnp.stack(
        [jnp.rint(y_mean).astype(jnp.int32), data.x_grid], axis=1)
    final_cost = curve_costs(
        data.grad_img, data.x_grid, y_mean[:, None],
        kde_thresh=cfg.kde_thresh, cols=data.grad_cols,
        even="avg" if cfg.legacy_simpson else "simpson")[0]
    return TraceResult(
        edge_trace=edge_trace, y_mean=y_mean, y_std=y_std,
        cred_interval=cred, cred_interval_px=cred_px, n_iters=state.it,
        converged=state.n_fobs >= cfg.algo_thresh, theta=theta, lml=lml,
        final_cost=final_cost, iter_curves=state.iter_curves,
        iter_costs=state.iter_costs, iter_nobs=state.iter_nobs,
        iter_thresh=state.iter_thresh,
        obs_x=jnp.concatenate([state.user_x, state.obs_x]),
        obs_y=jnp.concatenate([state.user_y, state.obs_y]),
        obs_valid=jnp.concatenate([state.user_valid, state.obs_valid]))


@functools.partial(jax.jit, static_argnames=("cfg",))
def run_trace(cfg: TracerConfig, data: TracerData,
              state0: TraceState, key=None) -> TraceResult:
    """The full trace as one XLA program (gpet.py:768-908).

    ``key`` (optional runtime PRNG key) defaults to ``PRNGKey(cfg.seed)``;
    passing it explicitly reruns with another seed without recompiling."""
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)

    # Loop-invariant blur factors, built once OUTSIDE the while loop
    # (see kde.blur_matrices — XLA re-ran the inline build every
    # iteration). Bitwise-identical ops, hoisted placement; the barrier
    # stops XLA rematerialising the build back into the loop body.
    blur = blur_matrices(cfg.M, cfg.N, data.grad_kde.dtype)
    if blur is not None:
        blur = jax.lax.optimization_barrier(blur)

    def cond(s: TraceState):
        return (s.n_fobs < cfg.algo_thresh) & (s.it < cfg.max_iters)

    def body(s: TraceState):
        new_state, _ = _iteration(cfg, data, key, s, blur=blur)
        return new_state

    state = jax.lax.while_loop(cond, body, state0)
    return finish_trace(cfg, data, state, key)


@functools.partial(jax.jit, static_argnames=("cfg",))
def trace_step(cfg: TracerConfig, data: TracerData,
               state: TraceState, key=None):
    """One jitted outer iteration, for the introspective driver path
    (per-iteration plotting / return_lines, gpet.py:843-844,905-908)."""
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    return _iteration(cfg, data, key, state)


@functools.partial(jax.jit, static_argnames=("cfg",))
def preview_samples(cfg: TracerConfig, data: TracerData,
                    state: TraceState, key=None):
    """Samples from the initial posterior (gpet.py:806:
    ``fit_predict_GP(self.obs, converged=False, seed=0)``).

    Default stream is ``PRNGKey(0)`` — the same ``seed → PRNGKey(seed)``
    mapping ``fit_predict_GP`` documents, applied to the reference's
    literal ``seed=0`` (independent of ``cfg.seed``, exactly like the
    reference)."""
    x, y, mask, noise_w = _train_set(cfg, data, state)
    if key is None:
        key = jax.random.PRNGKey(0)
    return _sample_round(cfg, data, x, y, mask, noise_w, key)
