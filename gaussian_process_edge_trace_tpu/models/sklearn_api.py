"""sklearn-style Gaussian-process regression API, JAX-native.

The reference package publicly exports its vendored
``GaussianProcessRegressor`` fork and ``WeightedWhiteKernel``
(reference: __init__.py:10-15, sklearn_gpr.py:31-610,617-721); users
compose them with stock sklearn ``ConstantKernel``/``RBF``/``Matern``
(gpet.py:165-178). This module provides the same surface on top of the
functional GP core:

- kernel objects :class:`ConstantKernel`, :class:`RBF`, :class:`Matern`,
  :class:`WeightedWhiteKernel` composable as ``C * RBF + W`` (the only
  composition shape the reference ever builds);
- :class:`GaussianProcessRegressor` with ``fit`` / ``predict`` /
  ``sample_y`` / ``log_marginal_likelihood`` and L-BFGS hyperparameter
  optimisation with restarts (sklearn_gpr.py:254-295) — restarts vmapped
  instead of host-looped;
- the fork's behavioural deltas are preserved: ``normalize_y`` removes the
  mean but does NOT scale (sklearn_gpr.py:225-240), and there is no hard
  convergence check on the optimiser (sklearn_gpr.py:596-599);
- the fork's train/query inference-by-shape hack (the noise kernel
  returning zeros when ``X.shape[0] == edge_length``,
  sklearn_gpr.py:672-677) is replaced by explicit semantics: observation
  noise enters the training Gram only, and predictions are noise-free —
  exactly what the hack achieved on the tracer's query grids.

Inputs are (n, 1) or (n,) arrays of scalar locations — the only input
shape the reference supports in practice (pixel columns).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from gaussian_process_edge_trace_tpu.models.gpr import (
    gp_fit, log_marginal_likelihood)
from gaussian_process_edge_trace_tpu.models.kernels import (
    KernelSpec, cross_gram)
from gaussian_process_edge_trace_tpu.models.lbfgs import minimize_lbfgs_b


def _as_bounds(b, default):
    if b == "fixed" or b is None:
        return None
    lo, hi = b
    return (float(lo), float(hi))


class ConstantKernel:
    """Scalar variance factor (sklearn ConstantKernel)."""

    def __init__(self, constant_value=1.0, constant_value_bounds=(1e-5, 1e5)):
        self.constant_value = float(constant_value)
        self.constant_value_bounds = constant_value_bounds

    def __mul__(self, other):
        return _ProductKernel(self, other)


class RBF:
    def __init__(self, length_scale=1.0, length_scale_bounds=(1e-5, 1e5)):
        self.length_scale = float(length_scale)
        self.length_scale_bounds = length_scale_bounds
        self.spec = KernelSpec(kind="RBF")


class Matern:
    def __init__(self, length_scale=1.0, nu=2.5,
                 length_scale_bounds=(1e-5, 1e5)):
        if nu not in (1.5, 2.5):
            raise NotImplementedError(
                "only nu in {1.5, 2.5} (the closed forms the reference "
                "instantiates, gpet.py:134,143)")
        self.length_scale = float(length_scale)
        self.nu = float(nu)
        self.length_scale_bounds = length_scale_bounds
        self.spec = KernelSpec(kind="Matern", nu=float(nu))


class WeightedWhiteKernel:
    """Heteroscedastic white noise: ``noise_level * diag(noise_weight)``
    on the training Gram (sklearn_gpr.py:617-721, minus the query-shape
    hack — query covariance is noise-free by construction).

    ``edge_length`` is accepted for signature compatibility and ignored —
    it only existed to power the shape-sniffing hack."""

    def __init__(self, edge_length=None, noise_weight=1.0, noise_level=1.0,
                 noise_level_bounds=(1e-5, 1e5)):
        self.edge_length = edge_length
        self.noise_weight = np.asarray(noise_weight, dtype=np.float64)
        self.noise_level = float(noise_level)
        self.noise_level_bounds = noise_level_bounds

    def __radd__(self, other):
        return _CompositeKernel(other, self)

    def __add__(self, other):
        raise TypeError("WeightedWhiteKernel is additive noise; compose as "
                        "signal_kernel + WeightedWhiteKernel")


class _ProductKernel:
    """ConstantKernel * (RBF | Matern) — the reference's signal kernel
    (gpet.py:165-178)."""

    def __init__(self, const: ConstantKernel, stationary):
        if not isinstance(const, ConstantKernel):
            raise TypeError("left factor must be ConstantKernel")
        if not isinstance(stationary, (RBF, Matern)):
            raise TypeError("right factor must be RBF or Matern")
        self.k1 = const
        self.k2 = stationary

    def __add__(self, noise):
        if not isinstance(noise, WeightedWhiteKernel):
            raise TypeError("additive term must be WeightedWhiteKernel")
        return _CompositeKernel(self, noise)


class _CompositeKernel(NamedTuple):
    """signal (ConstantKernel*stationary) + WeightedWhiteKernel."""
    signal: _ProductKernel
    noise: WeightedWhiteKernel


def _from_sklearn(k):
    """Convert a stock ``sklearn.gaussian_process.kernels`` expression of
    the shapes the reference composes — ``C * RBF|Matern`` optionally
    ``+ WhiteKernel`` (sklearn_gpr.py:140-180, gpet.py:165-178) — into the
    native kernel objects, by attribute introspection (no sklearn import
    needed). Raises TypeError naming the supported set otherwise."""
    name = type(k).__name__
    if name == "Product":
        return _from_sklearn(k.k1) * _from_sklearn(k.k2)
    if name == "Sum":
        left = _from_sklearn(k.k1)
        if isinstance(left, (RBF, Matern)):
            left = _ProductKernel(ConstantKernel(1.0, "fixed"), left)
        return left + _from_sklearn(k.k2)
    if name == "ConstantKernel":
        return ConstantKernel(k.constant_value, k.constant_value_bounds)
    if name in ("RBF", "Matern"):
        ls = np.asarray(k.length_scale, dtype=np.float64).reshape(-1)
        if ls.size != 1:
            raise TypeError("anisotropic length_scale is not supported "
                            "(the reference only fits 1-D inputs)")
        if name == "RBF":
            return RBF(float(ls[0]), k.length_scale_bounds)
        return Matern(float(ls[0]), nu=float(k.nu),
                      length_scale_bounds=k.length_scale_bounds)
    if name in ("WhiteKernel", "WeightedWhiteKernel"):
        return WeightedWhiteKernel(
            noise_weight=getattr(k, "noise_weight", 1.0),
            noise_level=float(k.noise_level),
            noise_level_bounds=k.noise_level_bounds)
    raise TypeError(
        f"unsupported sklearn kernel component {name!r}: supported shapes "
        "are ConstantKernel * (RBF | Matern) [+ WhiteKernel]")


def _normalise_kernel(kernel):
    """Coerce any supported kernel expression to a _CompositeKernel with
    zero-noise default. Stock sklearn kernel objects (identified by
    module) are converted by introspection first (sklearn_gpr.py:140-180
    accepts arbitrary sklearn kernels; we support the composition shapes
    the reference builds)."""
    if type(kernel).__module__.split(".")[0] == "sklearn":
        return _normalise_kernel(_from_sklearn(kernel))
    if isinstance(kernel, _CompositeKernel):
        return kernel
    if isinstance(kernel, _ProductKernel):
        return _CompositeKernel(kernel, WeightedWhiteKernel(
            noise_weight=0.0, noise_level=0.0, noise_level_bounds="fixed"))
    if isinstance(kernel, (RBF, Matern)):
        return _CompositeKernel(
            _ProductKernel(ConstantKernel(1.0, "fixed"), kernel),
            WeightedWhiteKernel(noise_weight=0.0, noise_level=0.0,
                                noise_level_bounds="fixed"))
    raise TypeError(f"unsupported kernel expression: {kernel!r}")


class GaussianProcessRegressor:
    """JAX-native GPR mirroring the reference fork's semantics.

    Parameters follow sklearn_gpr.py:31-180: ``kernel``, ``alpha``
    (diagonal jitter), ``optimizer`` (``'fmin_l_bfgs_b'`` or ``None``),
    ``n_restarts_optimizer``, ``normalize_y`` (mean removal ONLY — the
    fork's delta), ``random_state``.
    """

    def __init__(self, kernel=None, alpha=1e-10, optimizer="fmin_l_bfgs_b",
                 n_restarts_optimizer=0, normalize_y=False,
                 copy_X_train=True, random_state=None):
        self.kernel = kernel
        self.alpha = alpha
        self.optimizer = optimizer
        self.n_restarts_optimizer = int(n_restarts_optimizer)
        self.normalize_y = bool(normalize_y)
        self.copy_X_train = copy_X_train
        self.random_state = 0 if random_state is None else int(random_state)

    # -- internals ----------------------------------------------------------

    def _params(self):
        k = self._kernel_
        c = k.signal.k1.constant_value
        ls = k.signal.k2.length_scale
        nz = k.noise.noise_level
        return k.signal.k2.spec, c, ls, nz

    def _noise_weight(self, n):
        w = np.broadcast_to(self._kernel_.noise.noise_weight, (n,))
        return jnp.asarray(w, jnp.float64)

    def _diag_noise(self, n):
        _, _, _, nz = self._params()
        return nz * self._noise_weight(n) + self.alpha

    # -- API ------------------------------------------------------------------

    def _y_transform(self, y):
        """The fork's target transform (sklearn_gpr.py:220-240): centre
        ONLY under normalize_y=True, centre AND scale under
        normalize_y=False — and ``predict`` always rescales by
        ``_y_train_std`` regardless (sklearn_gpr.py:385,401), which under
        normalize_y=True multiplies the centred posterior by a std that
        was never divided out. Faithfully reproduced, zero-std mapped to
        1 (_handle_zeros_in_scale); per-column for 2-D targets
        (sklearn_gpr.py:221-233 ``axis=0``)."""
        m = np.mean(y, axis=0)
        s = np.std(y, axis=0)
        s = np.where(s == 0.0, 1.0, s)
        y_proc = (y - m) if self.normalize_y else (y - m) / s
        return y_proc, m, s

    def fit(self, X, y):
        if self.kernel is None:
            # Fork default: both hyperparameters fixed (sklearn_gpr.py:
            # 198-201), so the default configuration skips optimisation.
            self.kernel = ConstantKernel(1.0, "fixed") * RBF(
                1.0, length_scale_bounds="fixed")
        # Optimise a deep copy — the fork clones (sklearn_gpr.py:203) and
        # never mutates the user's kernel objects.
        import copy
        self._kernel_ = _normalise_kernel(copy.deepcopy(self.kernel))
        X = np.asarray(X, dtype=np.float64).reshape(-1)
        y = np.asarray(y, dtype=np.float64)
        # Multi-output y (n, m): per-column posteriors sharing one Gram
        # (sklearn's multi_output=True path, inherited by the fork,
        # sklearn_gpr.py:211-218). 1-D when squeezed like the fork does.
        self._n_targets = None if y.ndim == 1 else y.shape[1]
        y2 = y.reshape(len(X), -1)
        n = X.shape[0]
        self.X_train_ = X
        self.y_train_ = y
        mask = jnp.ones((n,), bool)
        y_proc, self._y_train_mean, self._y_train_std = self._y_transform(
            y2)

        k = self._kernel_
        any_free = any(
            _as_bounds(b, None) is not None
            for b in (k.signal.k1.constant_value_bounds,
                      k.signal.k2.length_scale_bounds,
                      k.noise.noise_level_bounds))
        if self.optimizer is not None and any_free:
            self._optimize_theta(X, y_proc, mask)

        spec, c, ls, _ = self._params()
        # One Cholesky, per-column dual coefficients (Alg. 2.1 batched
        # over targets, sklearn_gpr.py:304-320).
        self._state = gp_fit(spec, jnp.asarray(X),
                             jnp.asarray(y_proc[:, 0]), ls, c,
                             self._diag_noise(n), mask, centre=False)
        from jax.scipy.linalg import cho_solve
        self._y_proc = y_proc                                # (n, m)
        self._alpha_multi = cho_solve((self._state.L, True),
                                      jnp.asarray(y_proc))   # (n, m)
        self.kernel_ = self._kernel_
        return self

    def _optimize_theta(self, X, y_proc, mask):
        """Maximise the LML over the free hyperparameters (sklearn order:
        θ = [log c, log ℓ, log σn²], fixed dimensions pinned).
        ``y_proc`` is the fork-transformed target."""
        k = self._kernel_
        b_c = _as_bounds(k.signal.k1.constant_value_bounds, (1e-5, 1e5))
        b_l = _as_bounds(k.signal.k2.length_scale_bounds, (1e-5, 1e5))
        b_n = _as_bounds(k.noise.noise_level_bounds, (1e-5, 1e5))
        theta0 = np.log([max(k.signal.k1.constant_value, 1e-300),
                         k.signal.k2.length_scale,
                         max(k.noise.noise_level, 1e-300)])
        lb = np.array([np.log(b[0]) if b else t
                       for b, t in zip((b_c, b_l, b_n), theta0)])
        ub = np.array([np.log(b[1]) if b else t
                       for b, t in zip((b_c, b_l, b_n), theta0)])

        spec = k.signal.k2.spec
        yc = jnp.asarray(y_proc)            # (n, m)
        noise_w = self._noise_weight(len(y_proc))
        xj = jnp.asarray(X)
        alpha = self.alpha

        def neg(theta):
            # Multi-output LML = sum over target columns
            # (sklearn_gpr.py:542-546 log_likelihood_dims.sum()).
            cols = jax.vmap(
                lambda ycol: log_marginal_likelihood(
                    spec, xj, ycol, mask, theta, noise_w, jitter=alpha),
                in_axes=1)(yc)
            return -jnp.sum(cols)

        obj = jax.value_and_grad(neg)
        key = jax.random.PRNGKey(self.random_state)
        restarts = jax.random.uniform(
            key, (self.n_restarts_optimizer, 3), jnp.float64,
        ) * (ub - lb) + lb
        starts = jnp.concatenate(
            [jnp.asarray(theta0)[None], restarts], axis=0)
        solve = functools.partial(minimize_lbfgs_b, obj,
                                  lb=jnp.asarray(lb), ub=jnp.asarray(ub),
                                  max_iters=64)
        res = jax.vmap(solve)(starts)
        best = int(jnp.argmin(jnp.where(jnp.isfinite(res.f), res.f,
                                        jnp.inf)))
        theta = np.asarray(res.x[best])
        k.signal.k1.constant_value = float(np.exp(theta[0]))
        k.signal.k2.length_scale = float(np.exp(theta[1]))
        k.noise.noise_level = float(np.exp(theta[2]))
        self.log_marginal_likelihood_value_ = float(-res.f[best])

    def predict(self, X, return_std=False, return_cov=False):
        X = np.asarray(X, dtype=np.float64).reshape(-1)
        if not hasattr(self, "_kernel_"):
            # Unfitted: prior predictions/samples (sklearn_gpr.py:363-378).
            if self.kernel is None:
                self.kernel = ConstantKernel(1.0, "fixed") * RBF(1.0)
            self._kernel_ = _normalise_kernel(self.kernel)
        spec, c, ls, _ = self._params()
        if not hasattr(self, "_state"):
            # Prior predictions (sklearn_gpr.py:363-378): zero mean,
            # kernel variance.
            mean = jnp.zeros(X.shape[0])
            if return_cov:
                return mean, cross_gram(spec, jnp.asarray(X),
                                        jnp.asarray(X), ls, c)
            if return_std:
                return mean, jnp.sqrt(jnp.full(X.shape[0], c))
            return mean
        # Per-column posterior means on the shared Cholesky; the fork's
        # un-normalisation broadcasts _y_train_std per target and squeezes
        # a trailing singleton target axis (sklearn_gpr.py:381-436).
        from jax.scipy.linalg import solve_triangular
        st = self._state
        Kq = cross_gram(spec, jnp.asarray(X), st.x, ls, c)
        mean_cols = Kq @ self._alpha_multi            # (nq, m)
        m, sd = self._y_train_mean, self._y_train_std
        y_mean = sd * np.asarray(mean_cols) + m
        if y_mean.shape[1] == 1:
            y_mean = np.squeeze(y_mean, axis=1)
        if not (return_std or return_cov):
            return y_mean
        V = solve_triangular(st.L, Kq.T, lower=True)
        if return_cov:
            base = np.asarray(
                cross_gram(spec, jnp.asarray(X), jnp.asarray(X), ls, c)
                - V.T @ V)
            y_cov = base[:, :, None] * (sd ** 2)      # (nq, nq, m)
            if y_cov.shape[2] == 1:
                y_cov = np.squeeze(y_cov, axis=2)
            return y_mean, y_cov
        var = np.asarray(jnp.maximum(c - jnp.sum(V * V, axis=0), 0.0))
        y_var = var[:, None] * (sd ** 2)              # (nq, m)
        if y_var.shape[1] == 1:
            y_var = np.squeeze(y_var, axis=1)
        return y_mean, np.sqrt(y_var)

    def _joint_prior_factor(self, Xq, spec, ls):
        """Unit-variance prior square-root over query ∪ train points.

        Host LAPACK f64 eigh (one small decomposition, cleaner in f64 than
        on the device in f32), cached per (query grid, ℓ): it depends only on
        the PRIOR (point locations + length-scale), never on the training
        targets, so repeated ``sample_y`` calls reuse it."""
        from gaussian_process_edge_trace_tpu.models.kernels import k_unit_np
        key = (Xq.tobytes(), float(ls), spec)
        cache = getattr(self, "_prior_factor_cache", None)
        if cache is None:
            cache = self._prior_factor_cache = {}
        F = cache.get(key)
        if F is None:
            P = np.concatenate([Xq, self.X_train_])
            d = np.abs(P[:, None] - P[None, :]) / float(ls)
            K = k_unit_np(spec, d)
            K[np.diag_indices_from(K)] += 1e-10
            w, V = np.linalg.eigh(K)
            F = jnp.asarray(V * np.sqrt(np.clip(w, 0.0, None))[None, :])
            if len(cache) >= 4:
                cache.clear()
            cache[key] = F
        return F

    def sample_y(self, X, n_samples=1, random_state=0):
        """Posterior draws at ``X`` (sklearn_gpr.py:440-473).

        Fitted models use **Matheron pathwise sampling** (the same rule as
        :func:`..models.gpr.fit_and_sample`): draw a joint prior path over
        query ∪ train points through a cached host-side prior factor, then
        correct it with the training residual through the fit's existing
        n×n Cholesky —

            s = f₀(X*) + K(X*,X) (K+Σ)⁻¹ (y − f₀(X) − ε)

        Exact in distribution (mean ``K*α``, covariance
        ``K** − K*(K+Σ)⁻¹K*ᵀ``), but the per-call nq×nq predictive
        covariance factorisation of the reference hot spot
        (sklearn_gpr.py:460-473) is gone: the only factorisation left is
        of the PRIOR, computed once per query grid and cached. Unfitted
        models keep the eigh prior draw.

        Returns (n_query, n_samples), or (n_query, n_targets, n_samples)
        for multi-output fits (sklearn_gpr.py:454-473)."""
        key = jax.random.PRNGKey(int(random_state))
        S = int(n_samples)
        if hasattr(self, "_state"):
            spec, c, ls, _ = self._params()
            Xq = np.asarray(X, dtype=np.float64).reshape(-1)
            nq, n = Xq.shape[0], self.X_train_.shape[0]
            F = self._joint_prior_factor(Xq, spec, ls)      # (nq+n, nq+n)
            st = self._state
            diag_noise = self._diag_noise(n)
            Kq = cross_gram(spec, jnp.asarray(Xq), st.x, ls, c)
            from jax.scipy.linalg import cho_solve
            sqrt_c = jnp.sqrt(jnp.asarray(c, F.dtype))
            sqrt_noise = jnp.sqrt(jnp.maximum(diag_noise, 0.0))
            yp = jnp.asarray(self._y_proc)                  # (n, m)
            m_, sd = self._y_train_mean, self._y_train_std

            def draw(y_col, sd_t, m_t, k):
                kp, kn = jax.random.split(k)
                z = jax.random.normal(kp, (nq + n, S), F.dtype)
                f0 = sqrt_c * (F @ z)                       # (nq+n, S)
                eps = sqrt_noise[:, None] * jax.random.normal(
                    kn, (n, S), F.dtype)
                resid = y_col[:, None] - f0[nq:] - eps
                A = cho_solve((st.L, True), resid)          # (n, S)
                s_proc = f0[:nq] + Kq @ A
                # The fork's unconditional std rescale (sklearn_gpr.py:
                # 385,401) — same quirk path as predict().
                return sd_t * s_proc + m_t

            if self._n_targets is None:
                return draw(yp[:, 0], sd[0], m_[0], key)
            # Multi-output (sklearn_gpr.py:454-473): one batched dispatch
            # vmapped over the target axis — same per-target fold_in keys
            # as the former host loop, so the draws are unchanged.
            keys = jnp.stack([jax.random.fold_in(key, t)
                              for t in range(yp.shape[1])])
            return jax.vmap(draw, in_axes=(1, 0, 0, 0), out_axes=1)(
                yp, jnp.asarray(sd), jnp.asarray(m_), keys
            )  # (nq, n_targets, n_samples)

        # Unfitted: prior draws — eigh of the prior covariance
        # (sklearn_gpr.py:363-378 prior branch).
        mean, cov = self.predict(X, return_cov=True)
        mean = jnp.asarray(mean)
        cov = jnp.asarray(cov)
        w, V = jnp.linalg.eigh(cov)
        Fq = V * jnp.sqrt(jnp.maximum(w, 0.0))[None, :]
        z = jax.random.normal(key, (cov.shape[0], S), mean.dtype)
        return mean[:, None] + Fq @ z

    def score(self, X, y):
        """Coefficient of determination R² (sklearn RegressorMixin.score;
        multi-output = uniform average over target columns)."""
        y = np.asarray(y, dtype=np.float64)
        pred = np.asarray(self.predict(X)).reshape(y.shape)
        y2 = y.reshape(len(y), -1)
        p2 = pred.reshape(len(y), -1)

        def r2(yc, pc):
            u = np.sum((yc - pc) ** 2)
            v = np.sum((yc - yc.mean()) ** 2)
            if v == 0.0:
                # Constant targets: R² ill-defined; sklearn returns 1 for
                # a perfect constant prediction, else 0.
                return 1.0 if u == 0.0 else 0.0
            return 1.0 - u / v

        return float(np.mean([r2(y2[:, t], p2[:, t])
                              for t in range(y2.shape[1])]))

    def log_marginal_likelihood(self, theta=None, eval_gradient=False):
        spec, c, ls, nz = self._params()
        if theta is None:
            theta = jnp.log(jnp.asarray([c, ls, max(nz, 1e-300)]))
        else:
            theta = jnp.asarray(theta)
        n = self.X_train_.shape[0]
        y_proc, _, _ = self._y_transform(
            np.asarray(self.y_train_).reshape(n, -1))
        yc = jnp.asarray(y_proc)
        mask = jnp.ones((n,), bool)

        def fn(t):
            # Sum over target columns (sklearn_gpr.py:542-546).
            cols = jax.vmap(
                lambda ycol: log_marginal_likelihood(
                    spec, jnp.asarray(self.X_train_), ycol, mask, t,
                    noise_weight=self._noise_weight(n),
                    jitter=self.alpha), in_axes=1)(yc)
            return jnp.sum(cols)

        if eval_gradient:
            val, grad = jax.value_and_grad(fn)(theta)
            return float(val), np.asarray(grad)
        return float(fn(theta))
