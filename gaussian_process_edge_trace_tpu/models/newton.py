"""Box-constrained damped-Newton polish for tiny (3-dim) objectives.

The converged-fit hyperparameter optimisation (gpet.py:240-248 →
sklearn_gpr.py:254-295) is a 3-dimensional LML maximisation. The reference
runs scipy L-BFGS-B to convergence from 13 starts; on an accelerator every
objective evaluation is a latency-bound Gram+Cholesky chain, so sequential depth —
not FLOPs — is the cost. This module trades L-BFGS's long iteration chains
for:

1. ONE batched screen of all starts (callers append a static grid over the
   log-hyperparameter box, making the screen a global-search stage), and
2. a short scan of damped-Newton steps on the ``n_polish`` best starts:
   each iteration evaluates the batched gradient+Hessian once, solves the
   (3, 3) Levenberg systems for a ladder of dampings, and picks each
   start's best candidate with one more batched value call — 2 sequential
   objective units per iteration, monotone by construction.

Property-tested against converged scipy L-BFGS-B from the same starts
across random (n, kernel, σf, ℓ, noise) problems (tests/test_gpr.py) —
zero optimum gaps at (n_polish=8, iters=6), where the previous 4×8 L-BFGS
polish left gaps up to 2 LML units.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class NewtonResult(NamedTuple):
    x: jnp.ndarray   # (d,) best iterate
    f: jnp.ndarray   # objective value at x


# Levenberg damping ladder: 0 = pure Newton (quadratic convergence near
# the optimum), large values = conservative gradient-like steps for
# indefinite/ill-conditioned Hessians far from it.
_LAMBDAS = (0.0, 1e-3, 1e-1, 10.0, 1e3)


def lml_screen_grid(lb, ub, dtype=jnp.float32):
    """Static screen grid over the (log c, log ℓ, log σn²) LML box.

    4×4 over the kernel hyperparameters crossed with the noise decades
    that matter (the LML is flat in log-noise once the noise is far below
    the signal) — appended to the reference's 13 random starts, this makes
    the batched screen a global search the short Newton polish can trust.
    96 + 13 starts; an earlier 5×5 grid (163 total) had no effect on the
    scipy-gap sweep (the c/ℓ dims are smooth — the Newton polish recovers
    a coarser screen; the noise decades are what the polish cannot
    basin-hop).
    """
    cs = jnp.linspace(lb[0], ub[0], 4)
    ls = jnp.linspace(lb[1], ub[1], 4)
    nz = jnp.clip(jnp.log(jnp.asarray(
        [1e-18, 1e-8, 1e-4, 1e-2, 1e-1, 0.5])), lb[2], ub[2])
    G = jnp.stack(jnp.meshgrid(cs, ls, nz, indexing="ij"),
                  axis=-1).reshape(-1, 3)
    return G.astype(dtype)


def screen_and_polish(values_fn, vg_fn, starts, lb, ub, n_polish=8,
                      iters=6, lambdas=_LAMBDAS,
                      fd_h=1e-3) -> NewtonResult:
    """Minimise a batched objective over the box ``[lb, ub]`` from
    ``starts``: screen every start, then damped-Newton-polish the
    ``n_polish`` best for ``iters`` iterations.

    The objective's gradient is analytic (:func:`..models.gpr.batched_lml`)
    and its Hessian is built from central differences of that gradient —
    the (2d+1)·P FD points ride the same batched call, so each iteration
    is two batched objective calls (one gradient batch, one
    candidate-value batch). The Levenberg ladder and value-based
    acceptance absorb the O(h²)+O(eps/h) FD error.

    Args:
      values_fn: (B, d) -> (B,) objective values (NaN/inf allowed).
      vg_fn: (B, d) -> ((B,), (B, d)) values and gradients.
    """
    d_dim = starts.shape[1]
    lam = jnp.asarray(lambdas, starts.dtype)
    eye = jnp.eye(d_dim, dtype=starts.dtype)
    offs = jnp.concatenate([jnp.zeros((1, d_dim), starts.dtype),
                            fd_h * eye, -fd_h * eye])     # (2d+1, d)

    f0s = values_fn(starts)
    n_polish = min(n_polish, starts.shape[0])
    _, top = jax.lax.top_k(-jnp.where(jnp.isfinite(f0s), f0s, jnp.inf),
                           n_polish)
    X = starts[top]                                       # (P, d)
    F = jnp.where(jnp.isfinite(f0s[top]), f0s[top], jnp.inf)

    def step(carry, _):
        X, F = carry
        P = X.shape[0]
        pts = (X[None, :, :] + offs[:, None, :]).reshape(-1, d_dim)
        _, gv = vg_fn(pts)
        gv = gv.reshape(2 * d_dim + 1, P, d_dim)
        G = jnp.where(jnp.isfinite(gv[0]), gv[0], 0.0)
        gp_ = jnp.where(jnp.isfinite(gv[1:1 + d_dim]),
                        gv[1:1 + d_dim], 0.0)
        gm_ = jnp.where(jnp.isfinite(gv[1 + d_dim:]),
                        gv[1 + d_dim:], 0.0)
        H = jnp.transpose((gp_ - gm_) / (2.0 * fd_h), (1, 0, 2))
        H = 0.5 * (H + jnp.transpose(H, (0, 2, 1)))       # symmetrise
        scale = jnp.maximum(
            jnp.max(jnp.abs(jnp.diagonal(H, axis1=1, axis2=2)), axis=1),
            1.0)
        Hd = (H[:, None]
              + (lam[None, :, None, None]
                 * scale[:, None, None, None]) * eye)
        rhs = jnp.broadcast_to(G[:, None, :, None],
                               Hd.shape[:2] + (d_dim, 1))
        dstep = -jnp.linalg.solve(Hd, rhs)[..., 0]
        gstep = -0.5 * G / jnp.maximum(
            jnp.linalg.norm(G, axis=1, keepdims=True), 1e-12)
        cand = jnp.concatenate([X[:, None] + dstep, (X + gstep)[:, None]],
                               axis=1)                    # (P, C, d)
        cand = jnp.clip(cand, lb, ub)
        C = cand.shape[1]
        fc = values_fn(cand.reshape(P * C, d_dim)).reshape(P, C)
        fc = jnp.where(jnp.isfinite(fc), fc, jnp.inf)
        j = jnp.argmin(fc, axis=1)
        fbest = jnp.take_along_axis(fc, j[:, None], axis=1)[:, 0]
        xbest = jnp.take_along_axis(cand, j[:, None, None], axis=1)[:, 0]
        better = fbest < F                                # monotone
        X = jnp.where(better[:, None], xbest, X)
        F = jnp.where(better, fbest, F)
        return (X, F), None

    (X, F), _ = jax.lax.scan(step, (X, F), None, length=iters)
    i = jnp.argmin(jnp.where(jnp.isfinite(F), F, jnp.inf))
    return NewtonResult(x=X[i], f=F[i])
