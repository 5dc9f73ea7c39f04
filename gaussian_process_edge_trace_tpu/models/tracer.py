"""``GP_Edge_Tracing`` — the reference-compatible user API.

Same constructor signature, defaults, clamping semantics, and return
conventions as the reference class (gpet.py:22-35, 768-908), wrapping the
fused XLA trace program in :mod:`..trace.driver`.

Two execution paths:

- **fused** (default): the whole trace — every GP round, sampling, KDE,
  selection, and the final LML-optimised fit — runs as one compiled XLA
  program (`run_trace`). This is the production path.
- **introspective**: when per-iteration output is requested
  (``show_post_iter``, ``return_lines``, or ``verbose``) the same jitted
  iteration body is driven from a Python loop so samples and observations
  can be plotted/collected each round (gpet.py:829-870) — identical
  numerics, one host sync per iteration.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_process_edge_trace_tpu.trace.driver import (
    _round_up, final_fit_buffers, finish_trace, init_state, make_config,
    make_data, preview_samples, run_trace, sample_round_buffers, trace_step)


class GP_Edge_Tracing:
    """Trace one edge in one gradient image via GP regression.

    Positional signature mirrors gpet.py:22-35 exactly:
    ``(init, grad_img, kernel_options, noise_y, obs, N_samples,
    score_thresh, delta_x, keep_ratio, pixel_thresh, seed, return_std,
    fix_endpoints)``. Keyword-first construction is also supported, plus
    extras of this implementation (``max_iters``) as keyword-only
    arguments.
    """

    def __init__(self, init, grad_img, kernel_options=(1, 3, 3), noise_y=1,
                 obs=np.array([], dtype=np.int8), N_samples=500,
                 score_thresh=1, delta_x=20, keep_ratio=0.1, pixel_thresh=5,
                 seed=42, return_std=False, fix_endpoints=True, *,
                 max_iters=48, reference_quirks=True, legacy_simpson=False):
        init = np.asarray(init)
        self.init = init[np.argsort(init[:, 0])].astype(int)  # gpet.py:95
        self.obs = np.asarray(obs).reshape(-1, 2).astype(np.int64)
        self.return_std = bool(return_std)

        grad_img = np.asarray(grad_img)
        self.cfg = make_config(
            init, grad_img.shape, kernel_options=kernel_options,
            noise_y=noise_y, n_user_obs=self.obs.shape[0],
            N_samples=N_samples, score_thresh=score_thresh, delta_x=delta_x,
            keep_ratio=keep_ratio, pixel_thresh=pixel_thresh, seed=seed,
            fix_endpoints=fix_endpoints, max_iters=max_iters,
            reference_quirks=reference_quirks,
            legacy_simpson=legacy_simpson)
        self.data = make_data(self.cfg, jnp.asarray(grad_img),
                              jnp.asarray(self.init))
        # Mirror the reference's public attributes (gpet.py:95-119).
        cfg = self.cfg
        self.x_st, self.x_en = cfg.x_st, cfg.x_en
        self.M, self.N = cfg.M, cfg.N
        self.edge_length = cfg.edge_length
        self.N_samples = cfg.N_samples
        self.N_subints = cfg.N_subints
        self.N_keep = cfg.N_keep
        self.algo_thresh = cfg.algo_thresh
        self.delta_x = cfg.delta_x
        self.keep_ratio = (float(keep_ratio) if 0 < keep_ratio <= 1 else 0.1)
        self.pixel_thresh = cfg.pixel_thresh
        self.score_thresh = cfg.score_thresh0
        self.kde_thresh = cfg.kde_thresh
        self.seed = cfg.seed
        self.fix_endpoints = cfg.fix_endpoints
        self.noise_y = cfg.noise_y
        self.sigma_f, self.sigma_l = cfg.sigma_f, cfg.sigma_l
        self.x_grid = np.asarray(self.data.x_grid)
        self.grad_img = np.asarray(self.data.grad_img)
        self.grad_kde = np.asarray(self.data.grad_kde)
        # Per-init noise weights (gpet.py:161-162). The tiled X mirror
        # (gpet.py:115) is materialised lazily via the ``X`` property.
        self._X = None
        self.alpha_init = np.full((self.init.shape[0],),
                                  cfg.init_noise_weight)

    @property
    def X(self):
        """Tiled (edge_length, N_samples) x-grid (gpet.py:115), mirrored
        for API parity only — nothing in the compiled path consumes it.
        Lazy: the eager tile allocated O(E·S) host memory on every
        construction (800 MB at E=1000, S=10⁵ f64, BASELINE config 4)."""
        if self._X is None:
            self._X = np.tile(self.x_grid[:, None], (1, self.N_samples))
        return self._X

    # -- helpers ----------------------------------------------------------

    def _obs_list(self, state):
        """Valid observations of ``state`` as an (n, 2) xy array."""
        xs = np.concatenate([np.asarray(state.user_x),
                             np.asarray(state.obs_x)])
        ys = np.concatenate([np.asarray(state.user_y),
                             np.asarray(state.obs_y)])
        valid = np.concatenate([np.asarray(state.user_valid),
                                np.asarray(state.obs_valid)])
        return np.stack([xs[valid], ys[valid]], axis=1).astype(np.int64)

    def _result_tuple(self, res, all_samples, all_obs, iter_curves,
                      return_lines):
        edge_trace = np.asarray(res.edge_trace)
        if self.return_std:
            cred = np.asarray(res.cred_interval)
            return edge_trace, (cred[0], cred[1])
        if not return_lines:
            return edge_trace
        return edge_trace, (all_samples, all_obs, iter_curves)

    # -- reference method surface ------------------------------------------
    # The reference exposes the pipeline stages as methods on the tracer
    # object (gpet.py:182-764); these thin methods delegate to the
    # functional core with the reference's signatures and return shapes.

    def _buffers_for_obs(self, obs):
        """Padded training buffers for init + an arbitrary xy observation
        array (gpet.py:209-214; sorting elided, the GP is
        permutation-invariant)."""
        obs = np.asarray(obs).reshape(-1, 2)
        n_init = self.init.shape[0]
        n = n_init + obs.shape[0]
        cap = max(8, _round_up(n, 8))
        x = np.zeros((cap,), np.int32)
        y = np.zeros((cap,), np.int32)
        mask = np.zeros((cap,), bool)
        noise_w = np.ones((cap,), np.float32)
        x[:n_init] = self.init[:, 0]
        y[:n_init] = self.init[:, 1]
        x[n_init:n] = obs[:, 0]
        y[n_init:n] = obs[:, 1]
        mask[:n] = True
        noise_w[:n_init] = self.cfg.init_noise_weight  # gpet.py:161-162
        return (jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                jnp.asarray(noise_w))

    def fit_predict_GP(self, obs, converged=False, seed=0):
        """Fit the GP on init + ``obs`` (gpet.py:182-268).

        ``converged=False``: draw ``N_samples`` posterior curves, returned
        as an (edge_length, N_samples) array (the reference's actual
        return shape at gpet.py:259-261). ``converged=True``: LML-optimised
        fit; returns ``(y_mean, y_std)`` (std in standardised-y units, the
        reference quirk, gpet.py:263-266).
        """
        x, y, mask, noise_w = self._buffers_for_obs(obs)
        key = jax.random.PRNGKey(seed)
        if not converged:
            return np.asarray(sample_round_buffers(
                self.cfg, self.data, x, y, mask, noise_w, key))
        y_mean, y_std = final_fit_buffers(self.cfg, self.data, x, y, mask,
                                          noise_w, key)
        return np.asarray(y_mean), np.asarray(y_std)

    def grad_interp(self, rows, cols, grid=False):
        """Bilinear gradient-image lookup — the reference's
        ``RectBivariateSpline(kx=1, ky=1)`` attribute (gpet.py:122-125),
        called as ``grad_interp(edge[:, 1], edge[:, 0], grid=False)``."""
        from gaussian_process_edge_trace_tpu.ops.interp import (
            bilinear_interp)
        rows = np.asarray(rows, np.float64)
        cols = np.asarray(cols, np.float64)
        if grid:
            rows, cols = rows[:, None], cols[None, :]
        return np.asarray(bilinear_interp(self.grad_img.astype(np.float64),
                                          rows, cols))

    def finite_diff(self, vec, typ=0, h=1):
        """Forward/backward/central differencing (gpet.py:336-367)."""
        from gaussian_process_edge_trace_tpu.ops.diff import finite_diff
        return np.asarray(finite_diff(np.asarray(vec), typ=typ, h=h))

    def cost_funct(self, edge):
        """Cost of one xy-space edge: arc length / line integral
        (gpet.py:371-410). Accepts arbitrary (n, 2) edges (not only curves
        on the x-grid)."""
        from gaussian_process_edge_trace_tpu.ops.diff import finite_diff
        from gaussian_process_edge_trace_tpu.ops.integrate import (
            simpson_nonuniform)
        from gaussian_process_edge_trace_tpu.ops.interp import (
            bilinear_interp)
        edge = np.asarray(edge, np.float64)
        edge = edge[edge[:, 0].argsort(), :]                 # gpet.py:391
        grad_score = np.asarray(bilinear_interp(
            self.grad_img.astype(np.float64), edge[:, 1],
            edge[:, 0])) + self.kde_thresh                   # gpet.py:392
        pixel_diff = np.cumsum(np.sqrt(
            np.sum(np.diff(edge, axis=0) ** 2, axis=1)))     # gpet.py:397
        deriv = np.asarray(finite_diff(edge[:, 1], typ=0, h=1))
        integrand = np.sqrt(1.0 + deriv ** 2)                # gpet.py:400-401
        line_integral = float(simpson_nonuniform(
            jnp.asarray(grad_score[:-1]), jnp.asarray(pixel_diff)))
        arc_length = float(simpson_nonuniform(
            jnp.asarray(integrand), jnp.asarray(edge[:-1, 0])))
        return arc_length / line_integral                    # gpet.py:408

    def get_best_curves(self, y_samples):
        """Rank posterior curves by cost (gpet.py:414-451). ``y_samples``
        is (edge_length, N_samples); returns ``(best_curves
        (E, N_keep, 2), best_costs (N_keep,), (optimal_curve (E, 2),
        optimal_cost))`` with curves stacked as xy pairs like the
        reference's ``np.stack((self.X, y_samples), axis=-1)``."""
        from gaussian_process_edge_trace_tpu.trace.scoring import (
            best_curves, curve_costs)
        y_samples = jnp.asarray(y_samples)
        costs = curve_costs(self.data.grad_img, self.data.x_grid,
                            y_samples, kde_thresh=self.kde_thresh)
        bc, bcosts = best_curves(y_samples, costs, self.N_keep)
        bc = np.asarray(bc)
        bcosts = np.asarray(bcosts)
        X = np.tile(self.x_grid[:, None], (1, self.N_keep))
        curves = np.stack([X, bc], axis=-1)                  # (E, K, 2)
        return curves, bcosts, (curves[:, 0, :], float(bcosts[0]))

    def kernel_density_estimate(self, best_curves=None, costs=None, bw=1):
        """Dual-mode KDE (gpet.py:455-529): curve mode when ``costs`` is
        given ((E, K, 2) xy curves weighted by normalised inverse cost),
        gradient-image mode otherwise. Returns the (M, N) min-max
        normalised KDE."""
        from gaussian_process_edge_trace_tpu.trace.kde import (
            curve_kde, gradient_kde)
        if costs is None or best_curves is None:             # gpet.py:503-509
            return np.asarray(gradient_kde(
                self.data.grad_img, kde_thresh=self.kde_thresh, bw=bw))
        y = jnp.asarray(np.asarray(best_curves)[:, :, 1])
        inv = 1.0 / np.asarray(costs)
        weights = jnp.asarray(inv / inv.sum())               # gpet.py:492-493
        return np.asarray(curve_kde(y, weights, self.M, self.N,
                                    self.x_st, bw=bw))

    def _select(self, kde_arr, pre_fobs, cand_mask=None):
        """Shared body of compute_new_obs/get_best_pixels: run the dense
        selection round, persist the adaptive threshold (gpet.py:595),
        return compact xy fobs."""
        from gaussian_process_edge_trace_tpu.trace.select import (
            select_pixels)
        pre = np.asarray(pre_fobs).reshape(-1, 2).astype(np.int64)  # yx
        n = pre.shape[0]
        cap = max(8, _round_up(n, 8))
        ox = np.zeros((cap,), np.int32)
        oy = np.zeros((cap,), np.int32)
        ov = np.zeros((cap,), bool)
        ox[:n] = pre[:, 1]
        oy[:n] = pre[:, 0]
        ov[:n] = True
        cfg = self.cfg
        sel = select_pixels(
            jnp.asarray(kde_arr, jnp.float32), self.data.grad_kde,
            jnp.asarray(ox), jnp.asarray(oy), jnp.asarray(ov), n_pre=n,
            score_thresh=jnp.float32(self.score_thresh), spec=cfg.bins,
            fix_endpoints=cfg.fix_endpoints, kde_thresh=cfg.kde_thresh,
            pixel_thresh=cfg.pixel_thresh, algo_thresh=cfg.algo_thresh,
            max_decays=cfg.max_decays,
            cand_mask=(None if cand_mask is None
                       else jnp.asarray(cand_mask, bool)))
        self.score_thresh = float(sel.score_thresh)
        valid = np.asarray(sel.obs_valid)
        return np.stack([np.asarray(sel.obs_x)[valid],
                         np.asarray(sel.obs_y)[valid]],
                        axis=1).astype(np.int64)

    def compute_new_obs(self, pixel_idx, kde_arr, pre_fobs):
        """Score the given yx candidate pixels + rescored previous obs,
        adaptively threshold, per-bin NMS (gpet.py:532-619). Returns the
        accepted xy fobs, one per occupied bin."""
        pixel_idx = np.asarray(pixel_idx).reshape(-1, 2)
        cand = np.zeros((self.M, self.N), bool)
        cand[pixel_idx[:, 0], pixel_idx[:, 1]] = True
        return self._select(kde_arr, pre_fobs, cand_mask=cand)

    def get_best_pixels(self, best_curves, costs, pre_fobs):
        """KDE of the best curves → candidate pixels (with the
        fixed-endpoint column exclusion) → :meth:`compute_new_obs`
        (gpet.py:622-662). ``pre_fobs`` is yx-space like the reference's
        call site (gpet.py:857)."""
        kde_arr = self.kernel_density_estimate(best_curves, costs)
        return self._select(kde_arr, pre_fobs)

    def plot_iter(self, y_samples, N_plt_samples, obs):
        """Posterior fan chart (gpet.py:666-723)."""
        from gaussian_process_edge_trace_tpu.utils.plotting import plot_iter
        return plot_iter(self.x_grid, y_samples, N_plt_samples, obs,
                         self.init, (self.M, self.N))

    def plot_diagnostics(self, iter_optimal_curves, iter_optimal_costs,
                         credint=None):
        """Optimal curve per iteration + cost scatter (gpet.py:727-764)."""
        from gaussian_process_edge_trace_tpu.utils.plotting import (
            plot_diagnostics)
        return plot_diagnostics(self.grad_img, self.x_grid,
                                iter_optimal_curves, iter_optimal_costs,
                                credint)

    # -- the trace ---------------------------------------------------------

    def __call__(self, print_final_diagnostics=False, show_init_post=False,
                 show_post_iter=False, verbose=False, return_lines=False,
                 ensemble=None):
        """Run the trace (gpet.py:768-908 semantics and return shapes).

        ``ensemble`` (additive over the reference signature): an int K
        runs best-of-K seed ensembling in one fused dispatch — K complete
        traces vmapped over per-member keys, returning the member with
        the lowest final cost (see ``parallel.trace_ensemble``; member 0
        is the default single-seed trace, so K=1 ≡ ``ensemble=None``).
        Incompatible with the introspective paths (``show_post_iter`` /
        ``return_lines`` / ``verbose``), which iterate one step at a
        time."""
        if ensemble is not None and (show_post_iter or return_lines
                                     or verbose):
            raise ValueError("ensemble= is incompatible with the "
                             "introspective options (show_post_iter / "
                             "return_lines / verbose)")
        if ensemble is not None and int(ensemble) < 1:
            raise ValueError(f"ensemble must be >= 1, got {ensemble}")
        cfg, data = self.cfg, self.data
        state = init_state(cfg, user_obs_xy=self.obs)

        all_samples = []
        all_obs = [self.obs]
        iter_curves = []
        iter_costs = []

        if show_init_post:
            y_samples = np.asarray(preview_samples(cfg, data, state))
            all_samples.append(y_samples)
            from gaussian_process_edge_trace_tpu.utils.plotting import (
                plot_iter)
            plot_iter(self.x_grid, y_samples, 20, self.obs, self.init,
                      (self.M, self.N))
            print("Are you happy with your choice of kernel? y/n")
            cont = input()
            if cont.lower()[0] != "y":
                return None

        alg_st = time.time()
        introspective = show_post_iter or return_lines or verbose

        if introspective:
            while True:
                # One bulk device->host transfer per iteration.
                h = jax.device_get(state)
                if not (int(h.n_fobs) < cfg.algo_thresh
                        and int(h.it) < cfg.max_iters):
                    state = h
                    break
                st = time.time()
                if verbose:
                    print("Fitting Gaussian process and computing next set "
                          "of observations...")
                prev_obs = self._obs_list(h)
                state, samples = trace_step(cfg, data, state)
                samples = np.asarray(samples)
                all_samples.append(samples)
                if show_post_iter:
                    from gaussian_process_edge_trace_tpu.utils.plotting \
                        import plot_iter
                    plot_iter(self.x_grid, samples, 20, prev_obs, self.init,
                              (self.M, self.N))
                h = jax.device_get(state)
                all_obs.append(self._obs_list(h))
                i = int(h.it) - 1
                iter_curves.append(np.stack(
                    [self.x_grid, h.iter_curves[i]], axis=1))
                iter_costs.append(float(h.iter_costs[i]))
                if verbose:
                    print(f"Number of observations: {int(h.n_fobs)}")
                    print(f"Iteration {int(h.it)} - Time Elapsed: "
                          f"{round(time.time() - st, 4)}\n\n")
            res = jax.device_get(finish_trace(cfg, data, state))
        else:
            # Single fused program; ONE bulk device->host transfer.
            if ensemble is not None:
                from gaussian_process_edge_trace_tpu.parallel import (
                    trace_ensemble)
                res = jax.device_get(
                    trace_ensemble(cfg, data, state, n_seeds=int(ensemble)))
            else:
                res = jax.device_get(run_trace(cfg, data, state))
            n = int(res.n_iters)
            iter_curves = [np.stack(
                [self.x_grid, res.iter_curves[i]], axis=1)
                for i in range(n)]
            iter_costs = [float(c) for c in res.iter_costs[:n]]

        # Persist the adaptive threshold like the reference's mutable
        # attribute (gpet.py:595).
        n_it = int(res.n_iters)
        self.score_thresh = (float(res.iter_thresh[n_it - 1]) if n_it > 0
                             else float(cfg.score_thresh0))

        edge_trace = np.asarray(res.edge_trace)
        all_samples.append(np.asarray(res.y_mean))
        all_obs.append(self._obs_list_from_result(res))
        iter_curves.append(edge_trace[:, [1, 0]])
        iter_costs.append(float(res.final_cost))

        cred = np.asarray(res.cred_interval)
        if print_final_diagnostics:
            from gaussian_process_edge_trace_tpu.utils.plotting import (
                plot_diagnostics)
            plot_diagnostics(self.grad_img, self.x_grid, iter_curves,
                             iter_costs, (cred[0], cred[1]))
        if verbose:
            print(f"Time elapsed before algorithm converged: "
                  f"{round(time.time() - alg_st, 3)}")

        self.last_result = res
        return self._result_tuple(res, all_samples, all_obs, iter_curves,
                                  return_lines)

    def _obs_list_from_result(self, res):
        valid = np.asarray(res.obs_valid)
        return np.stack([np.asarray(res.obs_x)[valid],
                         np.asarray(res.obs_y)[valid]], axis=1).astype(
                             np.int64)
