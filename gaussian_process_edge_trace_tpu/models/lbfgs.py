"""Bound-constrained L-BFGS, jittable and vmappable.

Replaces ``scipy.optimize.minimize(..., method='L-BFGS-B', jac=True)``
(reference: sklearn_gpr.py:587-607) for kernel-hyperparameter optimisation.
The reference deliberately removed the convergence check — "I don't need
convergence, I just need an approximate mean function"
(sklearn_gpr.py:596-599) — so a projected L-BFGS with Armijo backtracking
is more than sufficient, and unlike scipy it compiles into the trace
program and **vmaps over the 12 restarts** (sklearn_gpr.py:284-288)
instead of looping them on the host.

Accelerator-first structure (the objective is a Gram+Cholesky LML —
tiny but latency-bound when serialised):

- the Armijo line search evaluates ALL backtracking candidates in one
  **batched** objective call (``vmap`` over step sizes) and selects the
  first acceptable step, instead of scipy's sequential backtracking —
  identical accepted step, ~20× fewer sequential kernels per iteration;
- the outer loop is a ``lax.while_loop`` that exits as soon as the
  iterate converges (projected-gradient tolerance or line-search failure)
  rather than a fixed-length scan.

Bounds are handled by gradient projection: iterates are clipped to the box
and descent directions are zeroed along active constraints.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class LBFGSResult(NamedTuple):
    x: jnp.ndarray       # final iterate (within bounds)
    f: jnp.ndarray       # objective value at x
    n_iters: jnp.ndarray


def _project(x, lb, ub):
    return jnp.clip(x, lb, ub)


def _projected_dir(d, x, g, lb, ub, eps=1e-12):
    # Zero the direction along bound constraints that are active and
    # whose gradient pushes outward.
    at_lo = (x <= lb + eps) & (d < 0)
    at_hi = (x >= ub - eps) & (d > 0)
    return jnp.where(at_lo | at_hi, 0.0, d)


@partial(jax.jit, static_argnames=("fun", "max_iters", "history",
                                   "max_backtracks"))
def minimize_lbfgs_b(fun, x0, lb, ub, max_iters=64, history=8,
                     max_backtracks=20, tol=1e-9):
    """Minimise ``fun`` (returning ``(value, grad)``) within ``[lb, ub]``.

    ``fun`` must be jax-traceable and vmappable. All shapes are static;
    the solve is a ``lax.while_loop`` so it can itself be vmapped across
    restarts (converged restarts simply idle until all finish).
    """
    d = x0.shape[0]
    x0 = _project(x0, lb, ub)
    f0, g0 = fun(x0)

    S0 = jnp.zeros((history, d), x0.dtype)
    Y0 = jnp.zeros((history, d), x0.dtype)
    rho0 = jnp.zeros((history,), x0.dtype)
    steps = 0.5 ** jnp.arange(max_backtracks, dtype=x0.dtype)

    def direction(g, S, Y, rho):
        # Two-loop recursion; invalid pairs (rho == 0) are skipped.
        def bwd(carry, inp):
            q = carry
            s, y, r = inp
            a = r * jnp.dot(s, q)
            q = q - jnp.where(r > 0, a, 0.0) * y
            return q, a
        q, alphas = jax.lax.scan(bwd, g, (S, Y, rho), reverse=True,
                                 unroll=True)
        # Initial Hessian scaling from the most recent valid pair.
        sy = jnp.sum(S[-1] * Y[-1])
        yy = jnp.sum(Y[-1] * Y[-1])
        gamma = jnp.where((sy > 0) & (yy > 0), sy / yy, 1.0)
        r_vec = gamma * q

        def fwd(carry, inp):
            r_c = carry
            s, y, r, a = inp
            b = r * jnp.dot(y, r_c)
            r_c = r_c + jnp.where(r > 0, a - b, 0.0) * s
            return r_c, None
        r_vec, _ = jax.lax.scan(fwd, r_vec, (S, Y, rho, alphas),
                                unroll=True)
        return -r_vec

    def cond(state):
        x, f, g, S, Y, rho, done, it = state
        return (~done) & (it < max_iters)

    def body(state):
        x, f, g, S, Y, rho, done, it = state

        dvec = direction(g, S, Y, rho)
        dvec = _projected_dir(dvec, x, g, lb, ub)
        gd = jnp.dot(g, dvec)
        # Fall back to projected steepest descent if not a descent dir.
        sd = _projected_dir(-g, x, g, lb, ub)
        use_sd = gd >= 0
        dvec = jnp.where(use_sd, sd, dvec)
        gd = jnp.where(use_sd, jnp.dot(g, sd), gd)

        # Armijo backtracking: evaluate every candidate step in ONE
        # batched call, then pick the largest step satisfying the
        # sufficient-decrease condition (== scipy's first accepted step).
        # Values only — the gradients of rejected candidates would cost a
        # batched VJP; XLA dead-code-eliminates it when discarded, and the
        # accepted step gets one dedicated gradient evaluation below.
        xts = _project(x[None, :] + steps[:, None] * dvec[None, :], lb, ub)
        fts, _ = jax.vmap(fun)(xts)
        fts = fts.astype(f.dtype)
        accept = (fts <= f + 1e-4 * steps * gd) & jnp.isfinite(fts)
        j = jnp.argmax(accept)            # first True (steps descend)
        found = jnp.any(accept)
        t_best = jnp.where(found, steps[j], 0.0)

        x_new = _project(x + t_best * dvec, lb, ub)
        f_new, g_new = fun(x_new)
        f_new = f_new.astype(f.dtype)

        s = x_new - x
        yv = g_new - g
        sy = jnp.dot(s, yv)
        valid_pair = sy > 1e-10
        S = jnp.where(valid_pair, jnp.roll(S, -1, axis=0).at[-1].set(s), S)
        Y = jnp.where(valid_pair, jnp.roll(Y, -1, axis=0).at[-1].set(yv), Y)
        rho = jnp.where(valid_pair,
                        jnp.roll(rho, -1).at[-1].set(1.0 / sy), rho)

        # Convergence: projected gradient small or no line-search progress.
        pg = x_new - _project(x_new - g_new, lb, ub)
        new_done = (~found) | (jnp.max(jnp.abs(pg)) < tol)

        return (x_new, f_new, g_new, S, Y, rho, new_done, it + 1)

    init = (x0, f0, g0, S0, Y0, rho0, jnp.asarray(False),
            jnp.asarray(0, jnp.int32))
    x, f, g, S, Y, rho, done, it = jax.lax.while_loop(cond, body, init)
    return LBFGSResult(x=x, f=f, n_iters=it)
