"""GP engine tests vs sklearn/scipy oracles.

sklearn's GaussianProcessRegressor with a per-point ``alpha`` vector is an
*exact* oracle for the reference's WeightedWhiteKernel semantics: the
training Gram gets ``noise_level * weight_i + jitter`` on the diagonal and
query points get no noise (SURVEY.md C5).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from sklearn.gaussian_process import GaussianProcessRegressor as SkGPR
from sklearn.gaussian_process.kernels import (
    RBF as SkRBF, Matern as SkMatern, ConstantKernel as SkC, WhiteKernel)

from gaussian_process_edge_trace_tpu.models.kernels import (
    KernelSpec, cross_gram, train_gram, resolve_kernel_options)
from gaussian_process_edge_trace_tpu.models import gpr
from gaussian_process_edge_trace_tpu.models.lbfgs import minimize_lbfgs_b


def _data(n=23, seed=0):
    rng = np.random.RandomState(seed)
    x = np.sort(rng.rand(n) * 50)
    y = np.sin(x / 6.0) * 10 + rng.randn(n) * 0.5
    w = np.ones(n)
    w[0] = w[-1] = 1e-7
    return x, y, w


@pytest.mark.parametrize("spec,sk", [
    (KernelSpec("RBF"), SkRBF(length_scale=7.5)),
    (KernelSpec("Matern", 1.5), SkMatern(length_scale=7.5, nu=1.5)),
    (KernelSpec("Matern", 2.5), SkMatern(length_scale=7.5, nu=2.5)),
])
def test_gram_matches_sklearn(spec, sk):
    x, _, _ = _data()
    K = np.asarray(cross_gram(spec, jnp.asarray(x), jnp.asarray(x), 7.5, 3.2))
    Ksk = 3.2 * sk(x[:, None])
    np.testing.assert_allclose(K, Ksk, atol=1e-10)
    x2 = np.linspace(0, 60, 17)
    K = np.asarray(cross_gram(spec, jnp.asarray(x), jnp.asarray(x2), 7.5, 1.0))
    np.testing.assert_allclose(K, sk(x[:, None], x2[:, None]), atol=1e-10)


def test_resolve_kernel_options():
    spec, sf, sl = resolve_kernel_options(
        {"kernel": "RBF", "sigma_f": 75, "length_scale": 20}, 500, 500)
    assert spec == KernelSpec("RBF", 2.5) and sf == 75 and sl == 20
    spec, sf, sl = resolve_kernel_options((1, 3, 3), 500, 500)
    assert spec == KernelSpec("Matern", 2.5)
    assert sf == 500 // 6 and sl == 500 // 2
    spec, _, _ = resolve_kernel_options((2, 1, 1), 500, 500)
    assert spec == KernelSpec("Matern", 1.5)


def _oracle_gpr(spec_sk, x, yc, diag_noise):
    gp = SkGPR(kernel=spec_sk, alpha=diag_noise, optimizer=None,
               normalize_y=False)
    gp.fit(x[:, None], yc)
    return gp


def test_fit_predict_matches_sklearn():
    x, y, w = _data()
    ls, var, noise = 7.5, 60.0, 1.3
    diag_noise = noise * w + 1e-6
    spec = KernelSpec("RBF")

    state = gpr.gp_fit(spec, jnp.asarray(x), jnp.asarray(y), ls, var,
                       jnp.asarray(diag_noise),
                       jnp.ones(len(x), dtype=bool), centre=True)
    xq = jnp.linspace(-5.0, 55.0, 41)
    mean, std = gpr.gp_predict(spec, state, xq, ls, var, return_std=True)
    mean2, cov = gpr.gp_predict(spec, state, xq, ls, var, return_cov=True)

    ym = y.mean()
    gp = _oracle_gpr(SkC(var, "fixed") * SkRBF(ls, "fixed"), x, y - ym,
                     diag_noise)
    mean_sk, std_sk = gp.predict(np.asarray(xq)[:, None], return_std=True)
    _, cov_sk = gp.predict(np.asarray(xq)[:, None], return_cov=True)

    np.testing.assert_allclose(np.asarray(mean), mean_sk + ym, atol=1e-8)
    np.testing.assert_allclose(np.asarray(mean2), mean_sk + ym, atol=1e-8)
    np.testing.assert_allclose(np.asarray(std), std_sk, atol=1e-7)
    np.testing.assert_allclose(np.asarray(cov), cov_sk, atol=1e-7)


def test_padding_is_exact():
    # Padded buffers must give bit-identical valid-block results.
    x, y, w = _data(17)
    ls, var = 9.0, 25.0
    diag_noise = 0.8 * w + 1e-6
    spec = KernelSpec("Matern", 2.5)
    xq = jnp.linspace(0, 50, 33)

    state = gpr.gp_fit(spec, jnp.asarray(x), jnp.asarray(y), ls, var,
                       jnp.asarray(diag_noise), jnp.ones(17, dtype=bool))
    m1, s1 = gpr.gp_predict(spec, state, xq, ls, var, return_std=True)

    CAP = 32
    pad = CAP - 17
    xp = jnp.concatenate([jnp.asarray(x), jnp.full(pad, 123.0)])
    yp = jnp.concatenate([jnp.asarray(y), jnp.full(pad, -7.0)])
    dn = jnp.concatenate([jnp.asarray(diag_noise), jnp.full(pad, 0.33)])
    mask = jnp.arange(CAP) < 17
    state_p = gpr.gp_fit(spec, xp, yp, ls, var, dn, mask)
    m2, s2 = gpr.gp_predict(spec, state_p, xq, ls, var, return_std=True)

    np.testing.assert_allclose(np.asarray(m2), np.asarray(m1), atol=1e-10)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), atol=1e-10)


def test_matheron_sampling_moments():
    # Matheron pathwise samples must match the exact posterior mean/cov.
    n, E, S = 9, 25, 60000
    rng = np.random.RandomState(4)
    grid = jnp.arange(E, dtype=jnp.float64)
    x_idx = np.sort(rng.choice(E, n, replace=False))
    x = grid[x_idx]
    y = np.cos(np.asarray(x) / 4.0) * 5 + rng.randn(n) * 0.3
    w = np.ones(n)
    w[0] = 1e-7
    ls, var, noise = 5.0, 16.0, 0.7
    diag_noise = jnp.asarray(noise * w + 1e-6)
    spec = KernelSpec("RBF")
    mask = jnp.ones(n, dtype=bool)

    Lp = gpr.prior_grid_cholesky(spec, grid, ls, jitter=1e-10)
    samples = gpr.fit_and_sample(
        jax.random.PRNGKey(0), spec, x, jnp.asarray(y), ls, var, diag_noise,
        mask, Lp, jnp.asarray(x_idx), jnp.arange(E), S)
    samples = np.asarray(samples)

    state = gpr.gp_fit(spec, x, jnp.asarray(y), ls, var, diag_noise, mask)
    mean, cov = gpr.gp_predict(spec, state, grid, ls, var, return_cov=True)
    mean, cov = np.asarray(mean), np.asarray(cov)

    emp_mean = samples.mean(axis=1)
    emp_cov = np.cov(samples)
    scale = np.sqrt(np.outer(np.diag(cov), np.diag(cov))) + 1e-3
    np.testing.assert_allclose(emp_mean, mean,
                               atol=4 * np.sqrt(np.diag(cov).max() / S) * 4)
    np.testing.assert_allclose(emp_cov / scale, cov / scale, atol=0.03)


def test_fit_and_sample_matches_textbook_matheron():
    """fit_and_sample's affine form c + P z + Q w is Matheron's rule
    f0(X*) + K*(K+Σ)⁻¹(y − f0(X) − ε) on the same normals, with padded
    training slots ignored."""
    n_valid, n, E, S = 7, 12, 30, 40
    rng = np.random.RandomState(8)
    grid = jnp.arange(E, dtype=jnp.float64)
    x_idx = np.zeros(n, np.int64)
    x_idx[:n_valid] = np.sort(rng.choice(E, n_valid, replace=False))
    x = jnp.asarray(x_idx, jnp.float64)
    y = jnp.asarray(np.where(np.arange(n) < n_valid,
                             rng.randn(n) * 3 + 10, -50.0))
    mask = jnp.arange(n) < n_valid
    ls, var, post = 6.0, 9.0, 0.8
    diag_noise = jnp.asarray(0.4 + rng.rand(n) * 0.1)
    spec = KernelSpec("RBF")
    Lp = gpr.prior_grid_cholesky(spec, grid, ls, jitter=1e-10)
    key = jax.random.PRNGKey(3)
    got = np.asarray(gpr.fit_and_sample(
        key, spec, x, y, ls, var, diag_noise, mask, Lp, jnp.asarray(x_idx),
        jnp.arange(E), S, post_scale=post))

    k_prior, k_noise = jax.random.split(key)
    z = np.asarray(jax.random.normal(k_prior, (Lp.shape[1], S), Lp.dtype))
    w = np.asarray(jax.random.normal(k_noise, (n, S), Lp.dtype))
    v = slice(0, n_valid)
    yv = np.asarray(y)[v]
    ym = yv.mean()
    f0 = np.sqrt(var) * np.asarray(Lp) @ z
    xv = np.asarray(x)[v]
    K = var * np.exp(-0.5 * (xv[:, None] - xv[None, :]) ** 2 / ls ** 2)
    K += np.diag(np.asarray(diag_noise)[v])
    Kq = var * np.exp(-0.5 * (np.arange(E)[:, None] - xv[None]) ** 2
                      / ls ** 2)
    eps = np.sqrt(np.asarray(diag_noise)[v])[:, None] * w[v]
    resid = (yv - ym)[:, None] - f0[x_idx[v]] - eps
    want = ym + post * (f0 + Kq @ np.linalg.solve(K, resid))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("E,R,N,S", [
    (70, 40, 24, 150),     # ragged tiles on every axis
    (64, 32, 104, 64),     # whole tiles; n > r
])
def test_posterior_draw_kernel_matches_jnp(E, R, N, S):
    """ops/posterior_draw.py (the Triton kernel, here in the Pallas
    interpreter, which contracts in f32) vs the plain map in f64."""
    from gaussian_process_edge_trace_tpu.ops.posterior_draw import (
        posterior_draw, posterior_draw_reference)

    rng = np.random.RandomState(E + N)
    c, P, z, Q, w = [jnp.asarray(rng.randn(*s), jnp.float32) for s in
                     [(E,), (E, R), (R, S), (E, N), (N, S)]]
    got = posterior_draw(c, P, z, Q, w, interpret=True)
    want = posterior_draw_reference(c.astype(jnp.float64),
                                    P.astype(jnp.float64), z, Q, w)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


def test_posterior_draw_kernel_independent_of_draw_width():
    """A column of the kernel's output has the same bits whether the draw
    holds S samples or any slice of them, and under vmap."""
    from gaussian_process_edge_trace_tpu.ops.posterior_draw import (
        posterior_draw)

    rng = np.random.RandomState(1)
    E, R, N, S = 50, 20, 16, 200
    c, P, z, Q, w = [jnp.asarray(rng.randn(*s), jnp.float32) for s in
                     [(E,), (E, R), (R, S), (E, N), (N, S)]]
    whole = np.asarray(posterior_draw(c, P, z, Q, w, interpret=True))
    for lo, hi in [(0, 100), (100, 200), (37, 163)]:
        part = posterior_draw(c, P, z[:, lo:hi], Q, w[:, lo:hi],
                              interpret=True)
        np.testing.assert_array_equal(np.asarray(part), whole[:, lo:hi])
    batched = jax.vmap(lambda cc: posterior_draw(cc, P, z, Q, w,
                                                 interpret=True))(
        jnp.stack([c, c + 1.0]))
    np.testing.assert_array_equal(np.asarray(batched[0]), whole)


def test_lml_value_and_grad_match_sklearn():
    x, y, w = _data(19, seed=7)
    yc = y - y.mean()
    spec = KernelSpec("RBF")
    mask = jnp.ones(19, dtype=bool)

    sk_kernel = (SkC(2.0, (1e-3, 1e4)) * SkRBF(4.0, (1e-2, 1e3))
                 + WhiteKernel(0.5, (1e-8, 1e2)))
    gp = SkGPR(kernel=sk_kernel, alpha=1e-6, optimizer=None,
               normalize_y=False)
    gp.fit(x[:, None], yc)

    theta = jnp.asarray(np.log([2.0, 4.0, 0.5]))
    fn = lambda th: gpr.log_marginal_likelihood(
        spec, jnp.asarray(x), jnp.asarray(yc), mask, th, jnp.ones(19))
    lml = float(fn(theta))
    lml_sk, grad_sk = gp.log_marginal_likelihood(
        np.asarray(theta), eval_gradient=True)
    np.testing.assert_allclose(lml, lml_sk, rtol=1e-9)
    grad = np.asarray(jax.grad(lambda th: fn(th))(theta))
    np.testing.assert_allclose(grad, grad_sk, rtol=1e-6, atol=1e-8)


def test_lml_padded_equals_unpadded():
    x, y, w = _data(15, seed=9)
    yc = y - y.mean()
    spec = KernelSpec("Matern", 1.5)
    theta = jnp.asarray(np.log([3.0, 6.0, 0.2]))
    v1 = float(gpr.log_marginal_likelihood(
        spec, jnp.asarray(x), jnp.asarray(yc), jnp.ones(15, bool), theta,
        jnp.asarray(w)))
    CAP = 24
    xp = jnp.concatenate([jnp.asarray(x), jnp.zeros(CAP - 15)])
    yp = jnp.concatenate([jnp.asarray(yc), jnp.ones(CAP - 15)])
    wp = jnp.concatenate([jnp.asarray(w), jnp.full(CAP - 15, 5.0)])
    mask = jnp.arange(CAP) < 15
    v2 = float(gpr.log_marginal_likelihood(spec, xp, yp, mask, theta, wp))
    np.testing.assert_allclose(v2, v1, rtol=1e-12)


def test_lml_nonpd_returns_neginf():
    # Duplicate points with ~zero noise -> singular Gram -> -inf, grad 0.
    x = jnp.asarray([1.0, 1.0, 2.0])
    yc = jnp.asarray([0.5, -0.5, 0.1])
    spec = KernelSpec("RBF")
    theta = jnp.asarray(np.log([1.0, 5.0, 1e-300]))
    fn = lambda th: gpr.log_marginal_likelihood(
        spec, x, yc, jnp.ones(3, bool), th, jnp.ones(3), jitter=0.0)
    assert float(fn(theta)) == -np.inf
    g = np.asarray(jax.grad(fn)(theta))
    assert np.all(np.isfinite(g) | (g == 0.0))


def test_lbfgs_on_quadratics_and_bounds():
    A = jnp.asarray(np.diag([1.0, 10.0, 100.0]))
    b = jnp.asarray([1.0, -2.0, 3.0])

    def fun(x):
        v = 0.5 * x @ A @ x - b @ x
        return v, A @ x - b
    lb = jnp.full(3, -10.0)
    ub = jnp.full(3, 10.0)
    res = minimize_lbfgs_b(fun, jnp.zeros(3), lb, ub)
    np.testing.assert_allclose(np.asarray(res.x),
                               np.linalg.solve(np.diag([1., 10., 100.]),
                                               np.asarray(b)), atol=1e-6)
    # Bound-active solution.
    ub2 = jnp.asarray([0.5, 10.0, 10.0])
    res2 = minimize_lbfgs_b(fun, jnp.zeros(3), lb, ub2)
    assert abs(float(res2.x[0]) - 0.5) < 1e-8


def test_lbfgs_optimizes_lml_vs_sklearn():
    # End-to-end hyperparameter optimisation parity: achieved LML within
    # tolerance of sklearn's L-BFGS-B with the same bounds/restarts.
    x, y, w = _data(21, seed=3)
    yc = (y - y.mean()) / y.std()
    xs = (x - x.mean()) / x.std()
    spec = KernelSpec("RBF")
    mask = jnp.ones(21, bool)

    bounds = np.log(np.array([[0.01, 1e3], [0.1, 100], [1e-18, 1.0]]))
    sk_kernel = (SkC(5.0, (0.01, 1e3)) * SkRBF(5.0, (0.1, 100))
                 + WhiteKernel(1.0, (1e-18, 1.0)))
    gp = SkGPR(kernel=sk_kernel, alpha=1e-6, optimizer="fmin_l_bfgs_b",
               n_restarts_optimizer=8, normalize_y=False, random_state=0)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        gp.fit(xs[:, None], yc)
    lml_sk = gp.log_marginal_likelihood_value_

    fn = jax.jit(jax.value_and_grad(
        lambda th: -gpr.log_marginal_likelihood(
            spec, jnp.asarray(xs), jnp.asarray(yc), mask, th,
            jnp.ones(21))))
    lb = jnp.asarray(bounds[:, 0])
    ub = jnp.asarray(bounds[:, 1])
    theta0 = jnp.asarray(np.log([5.0, 5.0, 1.0]))
    key = jax.random.PRNGKey(0)
    restarts = jax.random.uniform(key, (8, 3), minval=lb, maxval=ub,
                                  dtype=lb.dtype)
    starts = jnp.concatenate([theta0[None], restarts], axis=0)
    res = jax.vmap(lambda t0: minimize_lbfgs_b(fn, t0, lb, ub))(starts)
    best = -float(jnp.min(res.f))
    assert best >= lml_sk - 0.05, (best, lml_sk)


@pytest.mark.slow
def test_lml_optimum_matches_scipy_across_config_space():
    """Property test: the batched-screen + vmapped-L-BFGS
    polish used by the converged fit reaches the same LML optimum as
    scipy.optimize.minimize(L-BFGS-B) run to convergence from the SAME 13
    starts, across random (n, kernel, sigma_f, length-scale, noise)
    problems — not just the demo config (sklearn_gpr.py:254-295,587-607
    semantics)."""
    import functools
    from scipy.optimize import minimize

    from gaussian_process_edge_trace_tpu.models.gpr import (
        log_marginal_likelihood)
    from gaussian_process_edge_trace_tpu.trace.driver import optimize_lml

    lb = np.log(np.array([0.01, 0.1, 1e-18]))
    ub = np.log(np.array([1e3, 100.0, 1.0]))
    rng = np.random.default_rng(7)
    kinds = [KernelSpec(kind="RBF", nu=2.5),
             KernelSpec(kind="Matern", nu=1.5),
             KernelSpec(kind="Matern", nu=2.5)]

    @functools.partial(jax.jit, static_argnames=("spec",))
    def ours(spec, xs, ys, mask, noise_w, starts):
        return optimize_lml(spec, xs, ys, mask, noise_w, starts,
                            jnp.asarray(lb), jnp.asarray(ub))

    gaps = []
    for p in range(24):
        spec = kinds[p % 3]
        cap = [16, 32, 64][(p // 3) % 3]
        n = int(rng.integers(cap - 7, cap + 1))
        # Standardised inputs like the converged fit (gpet.py:233-238).
        x = np.sort(rng.uniform(-2, 2, size=n))
        true_ls = rng.uniform(0.2, 1.5)
        true_sf = rng.uniform(0.5, 30.0)
        K = true_sf * np.exp(-0.5 * ((x[:, None] - x[None, :])
                                     / true_ls) ** 2)
        y = np.linalg.cholesky(K + 1e-8 * np.eye(n)) @ rng.normal(size=n)
        y = y + rng.normal(0, rng.uniform(0.01, 1.0), size=n)
        y = (y - y.mean()) / max(y.std(), 1e-12)

        xs = np.zeros(cap); ys_ = np.zeros(cap)
        mask = np.zeros(cap, bool); noise_w = np.ones(cap)
        xs[:n], ys_[:n], mask[:n] = x, y, True
        noise_w[0] = rng.choice([1e-7, 0.5, 1.0])  # endpoint-style weight

        starts = np.concatenate(
            [np.clip(np.log([[5.0, 5.0, 1.0]]), lb, ub),
             rng.uniform(lb, ub, size=(12, 3))])

        def neg(theta):
            return -log_marginal_likelihood(
                spec, jnp.asarray(xs), jnp.asarray(ys_), jnp.asarray(mask),
                jnp.asarray(theta), jnp.asarray(noise_w), jitter=1e-6)

        neg_vg = jax.jit(jax.value_and_grad(neg))

        def scipy_obj(theta):
            f, g = neg_vg(theta)
            f = float(f)
            g = np.asarray(g, float)
            if not np.isfinite(f):          # scipy dislikes inf/nan pairs
                return 1e30, np.zeros(3)
            return f, g

        best_scipy = np.inf
        for s in starts:
            r = minimize(scipy_obj, s, jac=True, method="L-BFGS-B",
                         bounds=list(zip(lb, ub)))
            best_scipy = min(best_scipy, float(r.fun))

        theta, lml = ours(spec, jnp.asarray(xs), jnp.asarray(ys_),
                          jnp.asarray(mask), jnp.asarray(noise_w),
                          jnp.asarray(starts))
        gap = float(-lml) - best_scipy      # >0 means scipy found better
        gaps.append((p, spec.kind, spec.nu, n, gap))

    tol = 1e-3
    bad = [g for g in gaps if g[-1] > tol * 10]
    worst = max(g[-1] for g in gaps)
    # The screened 4x8 polish must match converged scipy within tol on
    # nearly every problem and never be catastrophically worse.
    n_over = sum(1 for g in gaps if g[-1] > tol)
    assert worst < 0.05, (worst, bad)
    assert n_over <= 2, (n_over, [g for g in gaps if g[-1] > tol])


@pytest.mark.parametrize("n,n_valid", [(24, 24), (32, 27)])
def test_batched_lml_value_and_grad_match_autodiff(n, n_valid):
    """batched_lml (the final fit's objective: batched jnp Cholesky and
    triangular solves, analytic trace-formula gradients) vs autodiff
    through log_marginal_likelihood, for an unpadded and a padded
    buffer."""
    rng = np.random.default_rng(n)
    spec = KernelSpec("RBF", 2.5)
    x = np.zeros(n)
    x[:n_valid] = np.sort(rng.uniform(-2, 2, n_valid))
    yc = np.zeros(n)
    yc[:n_valid] = rng.normal(size=n_valid)
    mask = np.arange(n) < n_valid
    nw = np.ones(n)
    nw[0] = 1e-7
    thetas = rng.uniform(-2, 2, size=(7, 3))
    vals, grads = gpr.batched_lml(
        spec, jnp.asarray(x), jnp.asarray(yc), jnp.asarray(mask),
        jnp.asarray(thetas), jnp.asarray(nw), jitter=1e-6, with_grad=True)
    only_vals = gpr.batched_lml(
        spec, jnp.asarray(x), jnp.asarray(yc), jnp.asarray(mask),
        jnp.asarray(thetas), jnp.asarray(nw), jitter=1e-6)

    def f(t):
        return gpr.log_marginal_likelihood(
            spec, jnp.asarray(x), jnp.asarray(yc), jnp.asarray(mask), t,
            jnp.asarray(nw), jitter=1e-6)

    rv, rg = jax.vmap(jax.value_and_grad(f))(jnp.asarray(thetas))
    np.testing.assert_allclose(np.asarray(vals), np.asarray(rv), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(only_vals), np.asarray(rv),
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(grads), np.asarray(rg),
                               rtol=1e-7, atol=1e-9)


@pytest.mark.slow
def test_batched_lml_matches_autodiff_oracle():
    """Batched LML values + analytic trace-formula gradients vs the
    autodiff log_marginal_likelihood, masks and all kernels."""
    rng = np.random.default_rng(0)
    n, B = 24, 9
    for spec in [KernelSpec("RBF", 2.5), KernelSpec("Matern", 1.5),
                 KernelSpec("Matern", 2.5)]:
        x = np.sort(rng.uniform(-2, 2, n))
        yc = rng.normal(size=n)
        mask = np.ones(n, bool)
        mask[-3:] = False
        yc[~mask] = 0
        nw = np.ones(n)
        nw[0] = 1e-7
        thetas = rng.uniform(-2, 2, size=(B, 3))
        vals, grads = gpr.batched_lml(
            spec, jnp.asarray(x), jnp.asarray(yc), jnp.asarray(mask),
            jnp.asarray(thetas), jnp.asarray(nw), jitter=1e-6,
            with_grad=True)

        def f(t):
            return gpr.log_marginal_likelihood(
                spec, jnp.asarray(x), jnp.asarray(yc), jnp.asarray(mask),
                t, jnp.asarray(nw), jitter=1e-6)

        rv, rg = jax.vmap(jax.value_and_grad(f))(jnp.asarray(thetas))
        np.testing.assert_allclose(np.asarray(vals), np.asarray(rv),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(grads), np.asarray(rg),
                                   rtol=1e-8, atol=1e-9)


@pytest.mark.slow
def test_optimize_lml_batched_path_matches_scipy():
    """The fit path (batched LML + FD-Hessian Newton) reaches the
    converged-scipy optimum on a few random problems."""
    from scipy.optimize import minimize

    from gaussian_process_edge_trace_tpu.trace.driver import optimize_lml

    lb = np.log(np.array([0.01, 0.1, 1e-18]))
    ub = np.log(np.array([1e3, 100.0, 1.0]))
    rng = np.random.default_rng(3)
    for p in range(4):
        spec = [KernelSpec("RBF", 2.5), KernelSpec("Matern", 1.5),
                KernelSpec("Matern", 2.5)][p % 3]
        n, cap = 27, 32
        x = np.sort(rng.uniform(-2, 2, size=n))
        K = 5.0 * np.exp(-0.5 * ((x[:, None] - x[None, :]) / 0.7) ** 2)
        y = np.linalg.cholesky(K + 1e-8 * np.eye(n)) @ rng.normal(size=n)
        y = (y + rng.normal(0, 0.3, size=n))
        y = (y - y.mean()) / y.std()
        xs = np.zeros(cap); ys_ = np.zeros(cap)
        mask = np.zeros(cap, bool); nw = np.ones(cap)
        xs[:n], ys_[:n], mask[:n] = x, y, True
        starts = np.concatenate(
            [np.clip(np.log([[5.0, 5.0, 1.0]]), lb, ub),
             rng.uniform(lb, ub, size=(12, 3))])

        def neg(theta):
            return -gpr.log_marginal_likelihood(
                spec, jnp.asarray(xs), jnp.asarray(ys_), jnp.asarray(mask),
                jnp.asarray(theta), jnp.asarray(nw), jitter=1e-6)

        nvg = jax.jit(jax.value_and_grad(neg))

        def sobj(t):
            f, g = nvg(t)
            if not np.isfinite(float(f)):
                return 1e30, np.zeros(3)
            return float(f), np.where(np.isfinite(g), np.asarray(g), 0.0)

        best = min(float(minimize(sobj, s, jac=True, method="L-BFGS-B",
                                  bounds=list(zip(lb, ub))).fun)
                   for s in starts)
        theta, lml = optimize_lml(
            spec, jnp.asarray(xs), jnp.asarray(ys_), jnp.asarray(mask),
            jnp.asarray(nw), jnp.asarray(starts), jnp.asarray(lb),
            jnp.asarray(ub))
        assert float(-lml) <= best + 1e-3, (p, float(-lml), best)


@pytest.mark.slow
@pytest.mark.parametrize("n,cap,rng_seed", [(201, 208, 7), (399, 408, 11)])
def test_optimize_lml_large_n(n, cap, rng_seed, tol=1e-3):
    """The fit path above n=160 (coarse-to-fine: subsampled screen+polish,
    then a full-n re-polish) reaches the converged-scipy optimum from the
    same starts. n=208 is the 1000-wide-image final-fit scale; n=408 the
    2000-wide one, where polishing the top-8 directly at full n left a
    70-LML-unit gap (the coarse stage converges every candidate basin
    cheaply first)."""
    from scipy.optimize import minimize

    from gaussian_process_edge_trace_tpu.trace.driver import optimize_lml

    lb = np.log(np.array([0.01, 0.1, 1e-18]))
    ub = np.log(np.array([1e3, 100.0, 1.0]))
    rng = np.random.default_rng(rng_seed)
    spec = KernelSpec("RBF", 2.5)
    x = np.sort(rng.uniform(-2, 2, size=n))
    K = 5.0 * np.exp(-0.5 * ((x[:, None] - x[None, :]) / 0.7) ** 2)
    y = np.linalg.cholesky(K + 1e-8 * np.eye(n)) @ rng.normal(size=n)
    y = y + rng.normal(0, 0.3, size=n)
    y = (y - y.mean()) / y.std()
    xs = np.zeros(cap)
    ys_ = np.zeros(cap)
    mask = np.zeros(cap, bool)
    nw = np.ones(cap)
    xs[:n], ys_[:n], mask[:n] = x, y, True
    starts = np.concatenate(
        [np.clip(np.log([[5.0, 5.0, 1.0]]), lb, ub),
         rng.uniform(lb, ub, size=(12, 3))])

    def neg(theta):
        return -gpr.log_marginal_likelihood(
            spec, jnp.asarray(xs), jnp.asarray(ys_), jnp.asarray(mask),
            jnp.asarray(theta), jnp.asarray(nw), jitter=1e-6)

    nvg = jax.jit(jax.value_and_grad(neg))

    def sobj(t):
        f, g = nvg(t)
        if not np.isfinite(float(f)):
            return 1e30, np.zeros(3)
        return float(f), np.where(np.isfinite(g), np.asarray(g), 0.0)

    best = min(float(minimize(sobj, s, jac=True, method="L-BFGS-B",
                              bounds=list(zip(lb, ub))).fun)
               for s in starts)
    theta, lml = optimize_lml(
        spec, jnp.asarray(xs), jnp.asarray(ys_), jnp.asarray(mask),
        jnp.asarray(nw), jnp.asarray(starts), jnp.asarray(lb),
        jnp.asarray(ub))
    assert float(-lml) <= best + tol, (float(-lml), best)
