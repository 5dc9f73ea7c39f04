"""Analytic FLOP model of the fused trace program, for MFU accounting.

The driver's wall-clock alone says nothing about how much of the device
is used; this module prices every dense
contraction in one outer-loop iteration and in the final LML fit so
benchmarks can report achieved FLOP/s and model-flop-utilisation against
the chip's peak.

Conventions: a (m, k) @ (k, n) matmul counts 2·m·k·n; a triangular solve
with an (n, n) factor against S right-hand sides counts n²·S (the ½ factor
of the triangle times the 2 of multiply-add); a Cholesky counts n³/3·2.
Elementwise work is only counted where it is O(E·S) or larger (the
interpolation and quadratures of the curve cost, and the KDE binning hat).

The model intentionally prices the *implemented* algorithm (e.g. the
size-gated blur as whichever form actually executes, the 2-candidate
in-loop jitter ladder, takes as zero FLOPs), not a theoretical
minimum — MFU is "how fast does the machine run the program we wrote".
"""

from __future__ import annotations


def iteration_flops(cfg) -> dict:
    """FLOPs of one `_iteration` (trace/driver.py) under config ``cfg``."""
    E = cfg.edge_length
    S = cfg.N_samples
    K = cfg.N_keep
    M, N = cfg.M, cfg.N
    n = cfg.n_train
    B = cfg.bins.n_bins
    Mp, Np = M + 2, N + 2       # padded KDE grid

    d = {}
    # --- Matheron sampling round (models/gpr.py::fit_and_sample) ---------
    d["gram"] = 8 * n * n                       # ~8 flops per kernel eval
    d["cholesky_x2"] = 2 * 2 * n ** 3 // 3      # batched jitter escalation
    # Truncated prior factor (driver.py::prior_factor): r = the prior's
    # numerical rank. The S-free factors of the affine map c + P z + Q w.
    from gaussian_process_edge_trace_tpu.trace.driver import prior_factor
    r = int(prior_factor(cfg)[0].shape[1])
    d["cross_gram"] = 8 * E * n                 # Kq kernel evals
    d["w_cho_solve"] = 2 * n * n * E            # W = Kq K⁻¹, two solves
    d["p_matmul"] = 2 * E * n * r               # W @ F_x
    # The draw itself: (E, r + n) @ (r + n, S).
    d["draw_matmul"] = 2 * E * (r + n) * S
    # --- curve costs (trace/scoring.py) -----------------------------------
    d["interp"] = 4 * E * S                     # two-tap lerp per point
    d["simpson"] = 10 * E * S                   # diffs/weights
    # Top-K curve extraction is a plain take since round 3 — no FLOPs.
    # --- curve KDE over the kept set (trace/kde.py) ------------------------
    d["kde_binning_hat"] = 2 * E * K * Mp       # per-column hat contraction
    # Blur: size-gated PER AXIS (trace/kde.py::_BLUR_MATMUL_MAX) — a
    # Toeplitz matmul on each axis that fits the gate, 17-tap shifted
    # FMAs on a long axis. The constant is imported so a retune cannot
    # desync this model from the implemented form.
    from gaussian_process_edge_trace_tpu.trace.kde import _BLUR_MATMUL_MAX
    d["kde_blur_ax0"] = (2 * Mp * Mp * Np if Mp <= _BLUR_MATMUL_MAX
                         else 2 * 17 * Mp * Np)
    d["kde_blur_ax1"] = (2 * Mp * Np * Np if Np <= _BLUR_MATMUL_MAX
                         else 2 * 17 * Mp * Np)
    # --- pixel selection (trace/select.py) ---------------------------------
    d["select_obs_onehot"] = 2 * M * (cfg.n_user_obs + B) * N
    d["select_dense_score"] = 8 * M * N
    d["select_bin_reduce"] = 2 * B * N
    d["select_decay_ladder"] = cfg.max_decays * B
    return d


def final_fit_flops(cfg) -> dict:
    """FLOPs of `_final_fit` as implemented (trace/driver.py::optimize_lml
    → models/newton.py): one batched screen of the 13 starts + 96-point
    grid, then an 8-start damped-Newton polish with FD Hessians (2
    batched objective units per iteration: a (2d+1)·P gradient batch and
    a P·(L+1) candidate-value batch). Above n=160 the fit is
    coarse-to-fine: the screen+polish run on a ≤112-point stride
    subsample, then a 2-start (polish_iters−1)-iteration re-polish at
    full n."""
    E = cfg.edge_length
    n = cfg.n_train
    starts = cfg.lml_restarts + 1 + 96    # + lml_screen_grid (4×4×6)
    n_polish, polish_iters = 8, 6
    n_candidates = 6                      # 5 dampings + gradient fallback
    d_dim = 3

    def lml_fwd(m):
        return 8 * m * m + 2 * m ** 3 // 3 + 2 * m * m   # gram+chol+solve

    def lml_vg(m):
        # batched_lml with_grad: value + analytic trace-formula gradient
        # (K^{-1} via two triangular solves with an (m, m) RHS).
        return lml_fwd(m) + 2 * m * m * m

    def screen_polish(m, n_starts, P, iters):
        grad_batch = (2 * d_dim + 1) * P * lml_vg(m)
        cand_batch = P * n_candidates * lml_fwd(m)
        return n_starts * lml_fwd(m) + iters * (grad_batch + cand_batch)

    d = {}
    if n <= 160:
        d["screen_polish"] = screen_polish(n, starts, n_polish,
                                           polish_iters)
    else:
        stride = -(-n // 112)
        n_sub = (n + stride - 1) // stride
        d["coarse_screen_polish"] = screen_polish(n_sub, starts, n_polish,
                                                  polish_iters)
        d["fine_polish"] = screen_polish(n, 2, 2,
                                         max(polish_iters - 1, 2))
    d["final_gp_fit"] = 8 * n * n + 2 * n ** 3 // 3 + 2 * n * n
    d["final_predict_std"] = 2 * E * n + n * n * E       # mean + V solve
    return d


def trace_flops(cfg, n_iters: int) -> dict:
    """Total FLOPs of one fused trace that ran ``n_iters`` iterations.

    Returns {"total": int, "per_iteration": int, "final_fit": int,
    "breakdown": {...}}.
    """
    it = iteration_flops(cfg)
    fin = final_fit_flops(cfg)
    per_iter = sum(it.values())
    final = sum(fin.values())
    return {
        "total": int(n_iters) * per_iter + final,
        "per_iteration": per_iter,
        "final_fit": final,
        "breakdown": {"iteration": it, "final_fit": fin},
    }


# Published dense peak of each supported device, FLOP/s, keyed by the
# ``device_kind`` JAX reports. Source: NVIDIA H100 data sheet, SXM part,
# bf16 tensor cores without sparsity, at the full 700 W power limit (a
# card set below it cannot hold that rate; report its power limit beside
# any share of this peak).
PEAK_BF16 = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def device_peak_flops(kind: str | None = None) -> float:
    """bf16 dense peak of ``kind`` (default: the first local device's
    ``device_kind``). A device not in :data:`PEAK_BF16` is an error."""
    if kind is None:
        import jax
        kind = jax.devices()[0].device_kind
    try:
        return PEAK_BF16[kind]
    except KeyError:
        raise ValueError(f"no peak FLOP/s known for device kind {kind!r}; "
                         f"known: {sorted(PEAK_BF16)}") from None


def mfu(total_flops: int, wall_seconds: float,
        peak: float | None = None) -> float:
    """Model-flop-utilisation: achieved FLOP/s over chip peak."""
    if peak is None:
        peak = device_peak_flops()
    return total_flops / wall_seconds / peak
