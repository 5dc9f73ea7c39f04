"""Functional Gaussian-process regression core (mask-aware, jit-first).

JAX replacement for the vendored sklearn fork
(reference: sklearn_gpr.py:31-610). Everything operates on fixed-shape
padded observation buffers (``mask`` marks valid points) so the whole
tracer compiles to one XLA program.

Key design decisions vs the reference:

- **Matheron pathwise sampling** (:func:`sample_posterior_matheron`)
  replaces ``predict(return_cov=True)`` + SVD ``multivariate_normal``
  (sklearn_gpr.py:460-473): posterior draws are
  ``f* = m + f0(X*) + K*(K+Σ)⁻¹(y - f0(X) - ε)`` with a *precomputed*
  prior Cholesky over the x-grid, so per-iteration cost is O(E·n²)
  matmuls rather than an O(E³) dense factorisation per call. Exact same
  posterior mean and covariance in exact arithmetic (see PAPERS.md,
  "Efficiently Sampling Functions from Gaussian Process Posteriors").
- **LML gradients**: :func:`log_marginal_likelihood` is differentiated by
  autodiff through the Cholesky; the tracer's final fit evaluates many
  θ at once with :func:`batched_lml`, which uses the reference's
  analytic trace formula (sklearn_gpr.py:548-580) in batched form.
- The reference's ``normalize_y=True`` fork removes the mean but does NOT
  scale (sklearn_gpr.py:225-240); :func:`gp_fit` mirrors that.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular

from gaussian_process_edge_trace_tpu.models.kernels import (
    KernelSpec, cross_gram, train_gram)


class GPState(NamedTuple):
    """Posterior state after :func:`gp_fit` (Alg. 2.1 lines 2-3)."""
    L: jnp.ndarray        # (n, n) lower Cholesky of the masked Gram
    alpha: jnp.ndarray    # (n,) dual coefficients (0 at padded slots)
    x: jnp.ndarray        # (n,) training inputs
    y_mean: jnp.ndarray   # scalar removed mean (0 if centre=False)
    mask: jnp.ndarray     # (n,) bool validity


def safe_cholesky(K, jitter_scales=(0.0, 1e-5, 1e-3)):
    """Lower Cholesky with branchless jitter escalation.

    The device compute path is float32; near-singular RBF Grams (condition
    numbers approaching 1/eps_f32) can make a plain Cholesky produce NaNs.
    The reference's failure mode is an exception with advice
    (sklearn_gpr.py:306-314); here we escalate a diagonal jitter instead —
    all candidate factorisations are computed (n is small, ≤ a few hundred)
    and the first finite one is selected, keeping the whole program
    branch-free under jit.
    """
    n = K.shape[-1]
    eye = jnp.eye(n, dtype=K.dtype)
    scale = jnp.mean(jnp.diagonal(K))
    jit_arr = jnp.asarray(jitter_scales, K.dtype) * scale
    # One BATCHED Cholesky over all candidates: one launch instead of
    # one per candidate.
    Ls = jnp.linalg.cholesky(K[None] + jit_arr[:, None, None] * eye[None])
    ok = jnp.all(jnp.isfinite(jnp.diagonal(Ls, axis1=-2, axis2=-1)), axis=-1)
    # First finite candidate (ascending jitter); if even the largest
    # jitter fails, return that attempt (NaNs propagate visibly) rather
    # than argmax-of-all-False silently picking the unjittered factor.
    idx = jnp.where(jnp.any(ok), jnp.argmax(ok), len(jitter_scales) - 1)
    return Ls[idx]


def masked_mean(y, mask):
    m = mask.astype(y.dtype)
    return jnp.sum(y * m) / jnp.maximum(jnp.sum(m), 1.0)


def masked_std(y, mask):
    m = mask.astype(y.dtype)
    n = jnp.maximum(jnp.sum(m), 1.0)
    mu = jnp.sum(y * m) / n
    return jnp.sqrt(jnp.sum(m * (y - mu) ** 2) / n)


def gp_fit(spec: KernelSpec, x, y, length_scale, variance, diag_noise,
           mask, centre=True):
    """Fit: Gram + Cholesky + dual coefficients (sklearn_gpr.py:304-320).

    ``centre=True`` reproduces the fork's normalize_y (mean removal only,
    sklearn_gpr.py:225-227). Padded slots decouple as an identity block.
    """
    y_mean = jnp.where(centre, masked_mean(y, mask), 0.0)
    yc = jnp.where(mask, y - y_mean, 0.0)
    K = train_gram(spec, x, length_scale, variance, diag_noise, mask=mask)
    L = safe_cholesky(K)
    alpha = cho_solve((L, True), yc)
    alpha = jnp.where(mask, alpha, 0.0)
    return GPState(L=L, alpha=alpha, x=x, y_mean=y_mean, mask=mask)


def gp_predict_mean(spec: KernelSpec, state: GPState, xq, length_scale,
                    variance):
    """Posterior mean at query points (sklearn_gpr.py:381-385)."""
    Kq = cross_gram(spec, xq, state.x, length_scale, variance)
    Kq = jnp.where(state.mask[None, :], Kq, 0.0)
    return Kq @ state.alpha + state.y_mean


def gp_predict(spec: KernelSpec, state: GPState, xq, length_scale, variance,
               return_std=False, return_cov=False):
    """Posterior mean and (optionally) std / full covariance.

    The query-point noise diagonal is zero, matching the reference's
    converged-predict path (WeightedWhiteKernel returns zeros for query
    sets, sklearn_gpr.py:672-677,714-717 — here by construction instead of
    by shape-sniffing).
    """
    Kq = cross_gram(spec, xq, state.x, length_scale, variance)
    Kq = jnp.where(state.mask[None, :], Kq, 0.0)
    mean = Kq @ state.alpha + state.y_mean
    if not (return_std or return_cov):
        return mean
    V = solve_triangular(state.L, Kq.T, lower=True)
    if return_cov:
        cov = cross_gram(spec, xq, xq, length_scale, variance) - V.T @ V
        return mean, cov
    var = variance - jnp.sum(V * V, axis=0)
    # Negative-variance clamp (sklearn_gpr.py:417-425), branchless.
    var = jnp.maximum(var, 0.0)
    return mean, jnp.sqrt(var)


def prior_grid_cholesky(spec: KernelSpec, grid, length_scale, jitter=1e-6):
    """Square-root factor of the unit-variance prior Gram over the grid.

    Computed once at tracer init (the grid and length-scale are fixed
    during the recursive scheme — the per-iteration constant-kernel value
    is a scalar multiple, gpet.py:230). O(E³) once instead of per
    iteration.

    Implemented via a symmetric eigendecomposition rather than Cholesky:
    a noise-free RBF Gram over hundreds of unit-spaced points is
    numerically rank-deficient in float32, where Cholesky NaNs out, while
    ``F = V·√max(λ,0)`` is robust and any F with FFᵀ = K yields the same
    sampling distribution — the same reason the reference's
    ``multivariate_normal`` uses an SVD factorisation (sklearn_gpr.py:464).
    """
    Kg = cross_gram(spec, grid, grid, length_scale, 1.0)
    Kg = Kg + jitter * jnp.eye(grid.shape[0], dtype=Kg.dtype)
    w, V = jnp.linalg.eigh(Kg)
    return V * jnp.sqrt(jnp.maximum(w, 0.0))[None, :]


def fit_and_sample(key, spec: KernelSpec, x, y, length_scale, variance,
                   diag_noise, mask, L_prior_unit, x_idx, grid_out,
                   n_samples, centre=True, post_scale=1.0,
                   sample_offset=0, total_samples=None):
    """Fit the GP and draw ``n_samples`` posterior curves over the grid.

    Replaces ``gp.fit`` + ``gp.sample_y`` (gpet.py:255-260 →
    sklearn_gpr.py:183,440). Matheron's rule:

        f*_j = ȳ + f0_j(X*) + K(X*,X) (K(X,X)+Σ)⁻¹ (yc − f0_j(X) − ε_j)

    with f0_j ~ GP(0, variance·k_unit) drawn on the full grid through the
    precomputed unit prior Cholesky, and ε_j ~ N(0, Σ) the heteroscedastic
    observation noise (Σ = diag_noise, the same diagonal added to the
    Gram). Mean and covariance match ``predict(return_cov=True)`` +
    ``multivariate_normal`` exactly in distribution.

    Args:
      x: (n,) padded training inputs; y: (n,) padded targets.
      diag_noise: (n,) full training noise diagonal (noise_level·weights
        + jitter).
      mask: (n,) validity.
      L_prior_unit: (G, G) Cholesky of the unit prior over the extended
        grid (:func:`prior_grid_cholesky`).
      x_idx: (n,) integer positions of each training input within the
        extended grid (training inputs are integer pixel columns, so they
        always lie on the grid).
      grid_out: (E,) integer positions of the output grid within the
        extended grid.
      n_samples: static sample count.
      post_scale: multiplier on the centred posterior (deviation +
        fluctuations) before the mean is re-added. The reference fork's
        ``predict`` unconditionally "undoes" a y-standardisation that
        ``normalize_y=True`` never applied (sklearn_gpr.py:227 removes the
        mean only, but :385,401 still multiply by ``_y_train_std``), so
        the tracer's sampling rounds effectively scale the centred
        posterior by ``std(y_scaled)`` — parity requires reproducing it.
      sample_offset / total_samples: sample-sharding contract. The random
        stream is DEFINED as the single ``(·, total_samples)`` draw from
        ``key`` (counter-based threefry: same key + same shape → the same
        array on every device); a shard drawing its ``n_samples = S/k``
        slice generates the full matrix and slices columns
        ``[offset, offset + n_samples)``. Sliced-away randoms cost
        microseconds next to the draw itself, the single-device path
        (``total_samples=None`` ⇒ no slice) is exactly the unsliced draw,
        and every mesh consumes the identical per-sample stream — the
        reference's seed-determinism contract (gpet.py:839) extended
        across meshes.

    Only z and w have a sample axis. Everything else folds into one
    affine map per round, built at sizes that do not depend on S: with
    W = K(X*,X) (K(X,X)+Σ)⁻¹ on the valid block,

        samples = c + P z + Q w,
        c = ȳ + s·W yc,   P = s·√variance·(F_grid − W F_x),   Q = −s·W·diag(√Σ)

    (s = ``post_scale``, F the prior factor's rows at the grid and at X).
    The (E, S) product runs through :func:`sample_map`, which on a GPU is
    a kernel whose per-sample bits do not depend on S, so a sample-sharded
    trace draws the curves one device draws. The S-free factors are
    computed at HIGHEST precision: P is a difference of two prior-scale
    terms, and TF32 rounding of either would land on the posterior spread.

    Returns:
      (E, n_samples) posterior curves (mean included).
    """
    E = grid_out.shape[0]
    S_tot = n_samples if total_samples is None else total_samples
    k_prior, k_noise = jax.random.split(key)
    hi = jax.lax.Precision.HIGHEST
    dt = L_prior_unit.dtype

    y_mean = jnp.where(centre, masked_mean(y, mask), 0.0)
    yc = jnp.where(mask, y - y_mean, 0.0)

    K = train_gram(spec, x, length_scale, variance, diag_noise, mask=mask)
    # Two-candidate jitter ladder: the sampling-round Gram carries the
    # full observation-noise diagonal (noise_y·weights, gpet.py:218-221),
    # so the unjittered factorisation is far from the f32 edge and the
    # middle 1e-5 rung is dead weight.
    L = safe_cholesky(K, jitter_scales=(0.0, 1e-3))

    Kq = cross_gram(spec, grid_out.astype(dt), x, length_scale, variance)
    Kq = jnp.where(mask[None, :], Kq, 0.0)                 # (E, n)
    Wt = jnp.where(mask[:, None], cho_solve((L, True), Kq.T), 0.0)  # (n, E)

    # L_prior_unit is (G, r) — the host eigendecomposition truncated to
    # the prior's numerical rank (trace/driver.py::prior_factor). The
    # output grid is contiguous within the extended grid (both are
    # integer pixel columns), so its rows are a dynamic slice.
    F_grid = jax.lax.dynamic_slice_in_dim(L_prior_unit, grid_out[0], E,
                                          axis=0)          # (E, r)
    F_x = jnp.take(L_prior_unit, x_idx, axis=0)            # (n, r)
    c = y_mean + post_scale * jnp.dot(yc, Wt, precision=hi)          # (E,)
    P = (post_scale * jnp.sqrt(variance)) * (
        F_grid - jnp.dot(Wt.T, F_x, precision=hi))         # (E, r)
    Q = -post_scale * Wt.T * jnp.sqrt(jnp.maximum(diag_noise, 0.0))[None, :]

    def local_slice(a):
        if S_tot == n_samples:
            return a
        return jax.lax.dynamic_slice_in_dim(a, sample_offset, n_samples,
                                            axis=1)

    # Prior draws (r, S) and heteroscedastic noise draws at the training
    # points (n, S).
    z = local_slice(jax.random.normal(k_prior, (L_prior_unit.shape[1],
                                                S_tot), dtype=dt))
    w = local_slice(jax.random.normal(k_noise, (x.shape[0], S_tot),
                                      dtype=dt))
    return sample_map(c.astype(dt), P.astype(dt), z, Q.astype(dt), w)


def use_draw_kernel() -> bool:
    """Whether :func:`sample_map` runs the GPU kernel
    (ops/posterior_draw.py) — on a GPU always, elsewhere never."""
    return jax.default_backend() == "gpu"


def sample_map(c, P, z, Q, w):
    """(E, S) ``c[:, None] + (P @ z + Q @ w)``: the GPU kernel, whose
    per-sample bits do not depend on S, or plain ``jnp`` elsewhere."""
    from gaussian_process_edge_trace_tpu.ops.posterior_draw import (
        posterior_draw, posterior_draw_reference)
    if use_draw_kernel():
        return posterior_draw(c, P, z, Q, w)
    return posterior_draw_reference(c, P, z, Q, w)


def log_marginal_likelihood(spec: KernelSpec, x, yc, mask, theta,
                            noise_weight, jitter=1e-6, pd_guard=True):
    """LML of θ = (log c, log ℓ, log σn²) for centred targets ``yc``.

    Matches sklearn_gpr.py:512-546 for the composite kernel
    ``C(c) * k_unit(ℓ) + σn²·diag(noise_weight)`` plus the fixed GPR
    ``alpha`` jitter. Padded slots contribute exactly zero (unit diagonal
    ⇒ log-det contribution 0, yc = 0 ⇒ quadratic contribution 0); the
    −n/2·log 2π constant uses the *valid* count for value parity.

    With ``pd_guard=True`` (default), returns −inf when the Gram is not
    positive definite (sklearn_gpr.py:520-522), with zero gradient there —
    at the cost of a second (probe) Cholesky per evaluation. With
    ``pd_guard=False`` the non-PD case yields NaN value/gradient instead;
    callers that sanitise NaNs themselves (the Newton hyperparameter
    polish, models/newton.py) use this to halve the Cholesky count on the
    latency-critical final-fit path. Identical values wherever K is PD.
    """
    c = jnp.exp(theta[0])
    ls = jnp.exp(theta[1])
    noise = jnp.exp(theta[2])
    diag_noise = noise * noise_weight + jitter
    K = train_gram(spec, x, ls, c, diag_noise, mask=mask)
    if pd_guard:
        # Probe factorisation (no gradient) to detect non-PD Grams, then
        # differentiate through a guaranteed-PD surrogate so the -inf
        # branch has zero (not NaN) gradient.
        probe = jnp.diagonal(jnp.linalg.cholesky(jax.lax.stop_gradient(K)))
        ok = jnp.all(jnp.isfinite(probe) & (probe > 0.0))
        K = jnp.where(ok, K, jnp.eye(K.shape[0], dtype=K.dtype))
    L = jnp.linalg.cholesky(K)
    a = cho_solve((L, True), yc)
    a = jnp.where(mask, a, 0.0)
    n_valid = jnp.sum(mask).astype(yc.dtype)
    lml = (-0.5 * jnp.sum(yc * a)
           - jnp.sum(jnp.log(jnp.where(mask, jnp.diagonal(L), 1.0)))
           - 0.5 * n_valid * jnp.log(2.0 * jnp.pi))
    if pd_guard:
        lml = jnp.where(ok, lml, -jnp.inf)
    return lml


def batched_lml(spec: KernelSpec, x, yc, mask, thetas, noise_weight,
                jitter=1e-6, with_grad=False):
    """LML of MANY θ = (log c, log ℓ, log σn²) at once.

    Same value as :func:`log_marginal_likelihood` per row (pd_guard=False
    semantics: non-PD Grams yield NaN for the caller to sanitise), with
    the B Cholesky factorisations and triangular solves as one batched
    (B, n, n) ``jnp.linalg.cholesky`` / ``solve_triangular`` each.
    Gradients are the reference's analytic trace formula
    (sklearn_gpr.py:548-580): ∂LML/∂θᵢ = ½ tr((ααᵀ − K⁻¹)·∂K/∂θᵢ), with
    K⁻¹ from one batched triangular solve — no autodiff.

    Args:
      thetas: (B, 3). Returns (B,) values, or (values, (B, 3) grads).
    """
    from gaussian_process_edge_trace_tpu.models.kernels import (
        dk_unit_dlog_ls, k_unit)

    dt = thetas.dtype
    x = x.astype(dt)
    yc = jnp.where(mask, yc, 0.0).astype(dt)
    noise_weight = noise_weight.astype(dt)
    B = thetas.shape[0]
    n = x.shape[0]
    c = jnp.exp(thetas[:, 0])
    ls = jnp.exp(thetas[:, 1])
    nz = jnp.exp(thetas[:, 2])

    r = jnp.abs(x[:, None] - x[None, :])                   # (n, n)
    d = r[None, :, :] / ls[:, None, None]                  # (B, n, n)
    Ku = k_unit(spec, d)
    m2 = (mask[:, None] & mask[None, :])[None]
    eye = jnp.eye(n, dtype=dt)
    diag_vals = jnp.where(mask[None, :],
                          nz[:, None] * noise_weight[None, :] + jitter,
                          0.0)                             # (B, n)
    # Off-diagonal signal zeroed outside the valid block; padded diagonal
    # = 1 (identity block, zero log-det contribution).
    K = (jnp.where(m2, c[:, None, None] * Ku, 0.0)
         * (1.0 - eye)[None]
         + eye[None] * (jnp.where(m2, c[:, None, None] * Ku, 0.0)
                        + diag_vals[:, None, :]
                        + jnp.where(mask, 0.0, 1.0)[None, None, :]))

    L = jnp.linalg.cholesky(K)
    w1 = solve_triangular(L, jnp.broadcast_to(
        yc[None, :, None], (B, n, 1)), lower=True)         # (B, n, 1)
    quad = jnp.sum(w1[..., 0] ** 2, axis=1)
    diagL = jnp.diagonal(L, axis1=1, axis2=2)
    logdet = jnp.sum(jnp.log(diagL), axis=1)
    n_valid = jnp.sum(mask).astype(dt)
    vals = (-0.5 * quad - logdet
            - 0.5 * n_valid * jnp.log(2.0 * jnp.pi).astype(dt))
    if not with_grad:
        return vals

    alpha = solve_triangular(L, w1, lower=True, trans=1)[..., 0]  # (B, n)
    alpha = jnp.where(mask[None, :], alpha, 0.0)
    Linv = solve_triangular(
        L, jnp.broadcast_to(eye[None], (B, n, n)), lower=True)  # (B, n, n)
    # K⁻¹ = L⁻ᵀ L⁻¹ as one batched matmul.
    Kinv = jnp.einsum("bki,bkj->bij", Linv, Linv,
                      precision=jax.lax.Precision.HIGHEST)
    A = alpha[:, :, None] * alpha[:, None, :] - Kinv

    dKc = jnp.where(m2, c[:, None, None] * Ku, 0.0)
    dKl = jnp.where(m2, c[:, None, None] * dk_unit_dlog_ls(spec, d), 0.0)
    g0 = 0.5 * jnp.sum(A * dKc, axis=(1, 2))
    g1 = 0.5 * jnp.sum(A * dKl, axis=(1, 2))
    diagA = jnp.diagonal(A, axis1=1, axis2=2)
    g2 = 0.5 * jnp.sum(diagA * (nz[:, None] * noise_weight[None, :])
                       * mask[None, :], axis=1)
    return vals, jnp.stack([g0, g1, g2], axis=1)
