"""Credible-interval calibration study.

Measures the quirks-off 95% pixel-unit credible interval's empirical
coverage of the true synthetic edge across configs × seeds, with the
re-derived CPU reference oracle (benchmarks/reference_cpu.py) run at the
same configs as the cross-check: if the oracle's corrected interval
under-covers the same way, the shortfall is ALGORITHM-level (the GP's
function-space posterior does not model pixel-level truth noise / gap
ambiguity — gpet.py:876 semantics), not an implementation defect.

Run: ``python -m benchmarks.coverage_study [--seeds N] [--oracle-seeds N]``.
Emits one JSON row per config plus a closing summary row; feeds the
PARITY.md coverage table and the tests/test_e2e_parity.py floor.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# (name, size, amplitude, curvature, noise, gaps, sigma_f, length_scale,
#  N_samples, delta_x, pixel_thresh, score_thresh)
CONFIGS = [
    ("128_smooth", (128, 128), 40, 2, 0.02, False, 30, 10, 256, 6, 4, 0.5),
    ("128_noisy_gaps", (128, 128), 40, 2, 0.10, True, 30, 10, 256, 6, 4,
     0.5),
    ("128_highcurv", (128, 128), 50, 5, 0.05, False, 30, 8, 256, 4, 4, 0.5),
    ("256_smooth", (256, 256), 90, 3, 0.03, False, 60, 16, 512, 6, 5, 0.5),
    ("256_noisy_gaps", (256, 256), 90, 3, 0.08, True, 60, 16, 512, 6, 5,
     0.5),
    # The README demo config — the one tests/test_e2e_parity.py gates on.
    ("500_demo_gaps", (500, 500), 200, 4, 0.05, True, 75, 20, 1000, 5, 5,
     1.0),
]


def _coverage(lo, hi, true_y):
    return float(np.mean((true_y >= lo) & (true_y <= hi)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--oracle-seeds", type=int, default=4)
    ap.add_argument("--only", default="",
                    help="substring filter on config names")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import gaussian_process_edge_trace_tpu as gpt
    from gaussian_process_edge_trace_tpu.trace.driver import (
        init_state, make_config, make_data, run_trace)
    from benchmarks.reference_cpu import ReferenceTracerCPU

    log("devices:", jax.devices())
    all_ours, all_oracle = [], []
    for (name, size, amp, curv, noise, gaps, sf, ls, S, dx,
         pth, sth) in CONFIGS:
        if args.only and args.only not in name:
            continue
        img, edge = gpt.construct_test_img(size, amp, curv, noise,
                                           "sinusoidal", 0.3, gaps=gaps)
        grad = np.asarray(gpt.comp_grad_img(img, gpt.kernel_builder(
            (9, 5) if size[0] < 300 else (11, 5))), np.float64)
        N = size[1]
        init = np.array([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
        ko = {"kernel": "RBF", "sigma_f": sf, "length_scale": ls}
        kw = dict(noise_y=1, N_samples=S, score_thresh=sth, delta_x=dx,
                  keep_ratio=0.1, pixel_thresh=pth, fix_endpoints=True)
        true_y = edge[:N, 0]

        cfg = make_config(init, grad.shape, kernel_options=ko, seed=1,
                          reference_quirks=False, **kw)
        data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
        state0 = init_state(cfg)
        covs, quirk_covs, mses = [], [], []
        for seed in range(1, args.seeds + 1):
            r = run_trace(cfg, data, state0, jax.random.PRNGKey(seed))
            lo, hi = np.asarray(r.cred_interval_px)
            covs.append(_coverage(lo, hi, true_y))
            lo2, hi2 = np.asarray(r.cred_interval)
            quirk_covs.append(_coverage(lo2, hi2, true_y))
            mses.append(float(gpt.trace_MSE(np.asarray(r.edge_trace),
                                            edge)))

        ocovs = []
        for seed in range(1, args.oracle_seeds + 1):
            ref = ReferenceTracerCPU(init, grad, ko, seed=seed, **kw)
            _, (olo, ohi), _ = ref()
            mean = 0.5 * (np.asarray(olo) + np.asarray(ohi))
            half_q = 0.5 * (np.asarray(ohi) - np.asarray(olo))
            half_px = half_q * ref.last_y_scale
            ocovs.append(_coverage(mean - half_px, mean + half_px,
                                   true_y))

        row = {
            "config": name, "seeds": args.seeds,
            "coverage_median": round(float(np.median(covs)), 3),
            "coverage_min": round(float(np.min(covs)), 3),
            "coverage_max": round(float(np.max(covs)), 3),
            "quirk_coverage_median":
                round(float(np.median(quirk_covs)), 3),
            "mse_median": round(float(np.median(mses)), 2),
            "oracle_seeds": args.oracle_seeds,
            "oracle_coverage_median":
                round(float(np.median(ocovs)), 3),
            "oracle_coverage_min": round(float(np.min(ocovs)), 3),
        }
        all_ours.extend(covs)
        all_oracle.extend(ocovs)
        print(json.dumps(row), flush=True)
        log(f"{name}: ours median {row['coverage_median']} "
            f"[{row['coverage_min']}, {row['coverage_max']}] | oracle "
            f"median {row['oracle_coverage_median']} "
            f"(min {row['oracle_coverage_min']}) | quirk "
            f"{row['quirk_coverage_median']}")

    summary = {
        "config": "summary_all",
        "ours_median": round(float(np.median(all_ours)), 3),
        "ours_p10": round(float(np.percentile(all_ours, 10)), 3),
        "ours_min": round(float(np.min(all_ours)), 3),
        "oracle_median": round(float(np.median(all_oracle)), 3),
        "oracle_min": round(float(np.min(all_oracle)), 3),
    }
    print(json.dumps(summary), flush=True)
    log("summary:", summary)


if __name__ == "__main__":
    main()
