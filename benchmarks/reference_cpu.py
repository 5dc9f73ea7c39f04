"""CPU baseline: the reference algorithm, faithfully re-derived in
NumPy/SciPy.

The reference itself cannot run in this image (its imports ``KDEpy`` and
``skimage`` are not installed), so this module re-implements the exact
algorithm from its formulas — the measured baseline row demanded by
BASELINE.md ("run the reference README demo config on this machine").
Semantics follow the reference per SURVEY.md §2/§3:

- GP sampling rounds: Gram + Cholesky + dual coefficients, posterior
  mean/cov on the grid, ``RandomState.multivariate_normal`` draws
  (sklearn_gpr.py:304-320, 381-409, 460-473), with the fork's
  mean-removal-only ``normalize_y`` (sklearn_gpr.py:225-240) and the
  sampling-mode scaling ``y_s = std(y)+1``, constant kernel σf²/y_s²
  (gpet.py:227-230);
- curve cost: bilinear gradient interpolation + Simpson quadratures in a
  per-sample Python loop (gpet.py:371-451) — the reference's own hot loop;
- KDE: linear binning + Gaussian convolution on the padded grid
  (FFTKDE's documented algorithm, gpet.py:514-527);
- pixel selection: argwhere candidates, rescored old observations,
  adaptive score threshold, per-bin argmax (gpet.py:532-662);
- converged fit: standardisation, L-BFGS-B LML maximisation with analytic
  gradients and 12 restarts (gpet.py:233-248, sklearn_gpr.py:254-295),
  predictive mean/std with the reference's unscaled-std quirk
  (gpet.py:263-266).

This is deliberately plain NumPy + SciPy on the host — the performance
baseline the JAX framework is measured against.
"""

from __future__ import annotations

import numpy as np
import scipy.integrate
import scipy.interpolate
import scipy.linalg
import scipy.optimize
import scipy.signal

SQRT3 = np.sqrt(3.0)
SQRT5 = np.sqrt(5.0)


def _normalise(img):
    img = np.asarray(img, dtype=np.float64)
    img = img - img.min()
    return img / img.max()


def _kernel_mat(kind, nu, x1, x2, ls):
    d = np.abs(x1[:, None] - x2[None, :]) / ls
    if kind == "RBF":
        return np.exp(-0.5 * d * d)
    s = (SQRT5 if nu == 2.5 else SQRT3) * d
    if nu == 2.5:
        return (1.0 + s + s * s / 3.0) * np.exp(-s)
    return (1.0 + s) * np.exp(-s)


def _dk_dlog_ls(kind, nu, x1, x2, ls):
    d = np.abs(x1[:, None] - x2[None, :]) / ls
    if kind == "RBF":
        return np.exp(-0.5 * d * d) * d * d
    s = (SQRT5 if nu == 2.5 else SQRT3) * d
    if nu == 2.5:
        return (s * s / 3.0) * (1.0 + s) * np.exp(-s)
    return s * s * np.exp(-s)


def _gaussian_2d(radius=8, bw=1.0):
    t = np.arange(-radius, radius + 1)
    g = np.exp(-0.5 * (t / bw) ** 2)
    return np.outer(g, g)


def _kde(points_xy, weights, M, N, radius=8):
    """Linear binning + Gaussian convolution + crop + min-max
    (gpet.py:514-527)."""
    pts = np.asarray(points_xy, dtype=float)
    w = np.asarray(weights, dtype=float)
    keep = (pts[:, 1] >= 0) & (pts[:, 1] <= M - 1)
    pts, w = pts[keep], w[keep]
    grid = np.zeros((M + 2, N + 2))
    gx, gy = pts[:, 0] + 1.0, pts[:, 1] + 1.0
    x0, y0 = np.floor(gx).astype(int), np.floor(gy).astype(int)
    fx, fy = gx - x0, gy - y0
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            np.add.at(grid, (y0 + dy, x0 + dx), w * wy * wx)
    blurred = scipy.signal.fftconvolve(grid, _gaussian_2d(radius),
                                       mode="same")
    kde = blurred[1:-1, 1:-1]
    return (kde - kde.min()) / (kde.max() - kde.min())


class ReferenceTracerCPU:
    """The reference edge tracer (gpet.py:17-908), NumPy/SciPy on the host."""

    def __init__(self, init, grad_img, kernel_options, noise_y=1,
                 obs=None, N_samples=500, score_thresh=1, delta_x=20,
                 keep_ratio=0.1, pixel_thresh=5, seed=42,
                 fix_endpoints=True, max_iters=48):
        init = np.asarray(init)
        self.init = init[np.argsort(init[:, 0])].astype(int)
        self.x_st, self.x_en = int(self.init[0, 0]), int(self.init[-1, 0])
        self.grad_img = _normalise(grad_img)
        self.M, self.N = self.grad_img.shape
        self.noise_y = noise_y
        self.N_samples = int(N_samples) if N_samples > 100 else 1000
        self.obs = (np.zeros((0, 2), np.int64) if obs is None
                    else np.asarray(obs).reshape(-1, 2).astype(np.int64))
        self.seed = seed
        self.keep_ratio = float(keep_ratio) if 0 < keep_ratio <= 1 else 0.1
        self.pixel_thresh = int(pixel_thresh) if pixel_thresh >= 2 else 2
        self.score_thresh = float(score_thresh) if 0 < score_thresh <= 1 else 1
        self.delta_x = int(delta_x) if delta_x > 3 else 2
        self.fix_endpoints = fix_endpoints
        self.kde_thresh = 1e-3
        self.max_iters = max_iters

        self.x_grid = self.x_st + np.arange(self.x_en - self.x_st + 1)
        self.edge_length = self.x_grid.shape[0]
        self.N_subints = int(self.edge_length // self.delta_x)
        self.N_keep = int(keep_ratio * N_samples)
        self.algo_thresh = self.N_subints - (self.pixel_thresh - 1)

        self.grad_interp = scipy.interpolate.RectBivariateSpline(
            np.arange(self.M), np.arange(self.N), self.grad_img, kx=1, ky=1)
        pts_yx = np.argwhere(self.grad_img > self.kde_thresh)
        self.grad_kde = _kde(pts_yx[:, ::-1].astype(float),
                             self.grad_img[pts_yx[:, 0], pts_yx[:, 1]],
                             self.M, self.N)

        if isinstance(kernel_options, dict):
            self.sigma_f = kernel_options["sigma_f"]
            self.sigma_l = kernel_options["length_scale"]
            self.kind = kernel_options["kernel"]
            self.nu = kernel_options.get("nu", 2.5)
        else:
            k, s_opt, l_opt = kernel_options
            self.kind = ["RBF", "Matern"][int(k > 0)]
            self.nu = [2.5, 1.5][int(k > 1)]
            self.sigma_f = self.M // ([10, 8, 6, 4, 2, 1][s_opt - 1]
                                      if 0 <= s_opt <= 5 else 1)
            self.sigma_l = self.edge_length // ([1, 4 / 3, 2, 4, 10][l_opt - 1]
                                                if 0 <= l_opt <= 4 else 10)
        self.alpha_const = [0.5, 1e-7][int(bool(fix_endpoints))]

    # -- GP rounds ----------------------------------------------------------

    def _train_arrays(self, obs):
        pts = np.concatenate([self.init, obs], axis=0)
        w = np.concatenate([np.full(self.init.shape[0], self.alpha_const),
                            np.ones(obs.shape[0])])
        order = np.argsort(pts[:, 0])
        return pts[order].astype(float), w[order]

    def _sample_round(self, obs, seed):
        pts, w = self._train_arrays(obs)
        x, y = pts[:, 0], pts[:, 1]
        y_s = np.std(y) + 1.0
        c = self.sigma_f ** 2 / y_s ** 2
        ys = y / y_s
        y_mean = ys.mean()           # normalize_y: mean removal only
        yc = ys - y_mean
        # Fork quirk: predict multiplies the centred posterior by
        # std(y_scaled) that fit never divided out (sklearn_gpr.py:227 vs
        # :385,401); zero std maps to 1 (_handle_zeros_in_scale, :223).
        s2 = np.std(ys)
        s2 = 1.0 if s2 == 0.0 else s2
        K = c * _kernel_mat(self.kind, self.nu, x, x, self.sigma_l)
        K[np.diag_indices_from(K)] += self.noise_y * w + 1e-6
        L = scipy.linalg.cholesky(K, lower=True)
        alpha = scipy.linalg.cho_solve((L, True), yc)
        Ks = c * _kernel_mat(self.kind, self.nu,
                             self.x_grid.astype(float), x, self.sigma_l)
        mean = s2 * (Ks @ alpha) + y_mean
        V = scipy.linalg.solve_triangular(L, Ks.T, lower=True)
        cov = s2 * s2 * (
            c * _kernel_mat(self.kind, self.nu, self.x_grid.astype(float),
                            self.x_grid.astype(float), self.sigma_l)
            - V.T @ V)
        rng = np.random.RandomState(seed)
        samples = rng.multivariate_normal(mean, cov, self.N_samples).T
        return samples * y_s        # (E, S)

    # -- cost / selection ----------------------------------------------------

    def _cost(self, y):
        gs = self.grad_interp(y, self.x_grid.astype(float),
                              grid=False) + self.kde_thresh
        dy = np.diff(y)
        step = np.sqrt(1.0 + dy * dy)
        curv = np.cumsum(step)
        line = scipy.integrate.simpson(gs[:-1], x=curv)
        arc = scipy.integrate.simpson(step, x=self.x_grid[:-1])
        return arc / line

    def _select(self, kde_arr, pre_fobs_xy):
        cand = np.argwhere(kde_arr > self.kde_thresh)
        if self.fix_endpoints:
            cand = cand[(cand[:, 1] > self.x_st) & (cand[:, 1] < self.x_en)]
        pre_yx = pre_fobs_xy[:, ::-1]
        n_pre = pre_yx.shape[0]
        old_int = kde_arr[pre_yx[:, 0], pre_yx[:, 1]]
        keep = old_int > self.kde_thresh
        old_yx, old_int = pre_yx[keep], old_int[keep]
        old_grad = self.grad_kde[old_yx[:, 0], old_yx[:, 1]]
        new_int = kde_arr[cand[:, 0], cand[:, 1]]
        new_grad = self.grad_kde[cand[:, 0], cand[:, 1]]
        pixels = np.concatenate([old_yx, cand])
        iv = np.concatenate([old_int, new_int])
        gv = np.concatenate([old_grad, new_grad])
        scores = (iv * gv + iv + gv) / 3.0

        # One unconditional thresholding pass before the decay loop so the
        # binned set is always defined (the upstream reference leaves
        # best/bins/uniq unbound when the loop body never runs,
        # gpet.py:589-616 — latent NameError fixed here).
        n_pix, i = n_pre, 0
        mask = scores >= self.score_thresh
        best, bs = pixels[mask], scores[mask]
        bins = np.round((best[:, 1] - self.x_st)
                        / self.delta_x).astype(int)
        uniq = np.unique(bins)
        while (n_pix - n_pre < self.pixel_thresh
               and n_pix < self.algo_thresh and i < 500):
            if i > 0:
                self.score_thresh *= 0.95
            mask = scores >= self.score_thresh
            best, bs = pixels[mask], scores[mask]
            bins = np.round((best[:, 1] - self.x_st)
                            / self.delta_x).astype(int)
            uniq = np.unique(bins)
            n_pix = uniq.shape[0]
            i += 1
        fobs = np.zeros((n_pix, 2), dtype=np.int64)
        for k, b in enumerate(uniq):
            sel = bins == b
            fobs[k] = best[sel][np.argmax(bs[sel])][::-1]
        return fobs

    # -- converged fit --------------------------------------------------------

    def _lml_and_grad(self, theta, x, yc, w):
        c, ls, nz = np.exp(theta)
        K = c * _kernel_mat(self.kind, self.nu, x, x, ls)
        dKs = [K.copy(),
               c * _dk_dlog_ls(self.kind, self.nu, x, x, ls),
               np.diag(nz * w)]
        K[np.diag_indices_from(K)] += nz * w + 1e-6
        try:
            L = scipy.linalg.cholesky(K, lower=True)
        except scipy.linalg.LinAlgError:
            return -np.inf, np.zeros(3)
        alpha = scipy.linalg.cho_solve((L, True), yc)
        lml = (-0.5 * yc @ alpha - np.log(np.diag(L)).sum()
               - 0.5 * len(yc) * np.log(2 * np.pi))
        Kinv = scipy.linalg.cho_solve((L, True), np.eye(len(yc)))
        A = np.outer(alpha, alpha) - Kinv
        grad = np.array([0.5 * np.sum(A * dK) for dK in dKs])
        return lml, grad

    def _final_fit(self, obs, seed):
        pts, w = self._train_arrays(obs)
        x, y = pts[:, 0], pts[:, 1]
        X_m, X_s = x.mean(), x.std()
        y_m, y_s = y.mean(), y.std()
        xs, ys = (x - X_m) / X_s, (y - y_m) / y_s

        def neg(theta):
            f, g = self._lml_and_grad(theta, xs, ys, w)
            return -f, -g

        lb = np.log([0.01, 0.1, 1e-18])
        ub = np.log([1e3, 100.0, 1.0])
        rng = np.random.RandomState(seed)
        starts = [np.log([5.0, 5.0, min(self.noise_y, 1.0)])]
        starts += [rng.uniform(lb, ub) for _ in range(12)]
        best_f, best_t = np.inf, starts[0]
        for t0 in starts:
            r = scipy.optimize.minimize(neg, t0, jac=True, method="L-BFGS-B",
                                        bounds=list(zip(lb, ub)))
            if r.fun < best_f:
                best_f, best_t = r.fun, r.x
        c, ls, nz = np.exp(best_t)
        K = c * _kernel_mat(self.kind, self.nu, xs, xs, ls)
        K[np.diag_indices_from(K)] += nz * w + 1e-6
        L = scipy.linalg.cholesky(K, lower=True)
        alpha = scipy.linalg.cho_solve((L, True), ys)
        xq = (self.x_grid - X_m) / X_s
        Ks = c * _kernel_mat(self.kind, self.nu, xq, xs, ls)
        mean = Ks @ alpha
        V = scipy.linalg.solve_triangular(L, Ks.T, lower=True)
        var = np.maximum(c - np.sum(V * V, axis=0), 0.0)
        std = np.sqrt(var)
        # Stash the y standardisation scale so calibration studies can
        # form the CORRECTED pixel-unit interval (mean ± 1.96·y_s·std)
        # without changing the quirk-preserving return contract.
        self.last_y_scale = y_s
        return y_s * mean + y_m, std   # std unscaled: reference quirk

    # -- driver ---------------------------------------------------------------

    def __call__(self):
        pre_fobs = self.obs
        n_iter = 0
        while (pre_fobs.shape[0] < self.algo_thresh
               and n_iter < self.max_iters):
            samples = self._sample_round(pre_fobs, self.seed + n_iter + 1)
            costs = np.array([self._cost(samples[:, s])
                              for s in range(self.N_samples)])
            order = np.argsort(costs)[: self.N_keep]
            bc, bcost = samples[:, order], costs[order]
            inv = 1.0 / bcost
            wts = inv / inv.sum()
            pts = np.stack([np.tile(self.x_grid[:, None],
                                    (1, self.N_keep)).ravel(),
                            bc.ravel()], axis=1)
            wpts = np.tile(wts[None, :], (self.edge_length, 1)).ravel()
            kde_arr = _kde(pts, wpts, self.M, self.N)
            pre_fobs = self._select(kde_arr, pre_fobs)
            n_iter += 1
        mean, std = self._final_fit(pre_fobs, self.seed + n_iter)
        cred = (mean - 1.96 * std, mean + 1.96 * std)
        edge_trace = np.rint(np.stack([mean, self.x_grid.astype(float)],
                                      axis=1)).astype(int)
        return edge_trace, cred, n_iter
