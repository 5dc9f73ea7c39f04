"""End-to-end demo: the reference README walkthrough (README.md:37-89)
on the JAX framework.

Builds the noisy sinusoidal test image with occlusion gaps, computes the
gradient image with the extended-Sobel kernel, traces the edge with fixed
endpoints, and reports the trace metrics. Pass ``--plot`` to save the
result figure.
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gaussian_process_edge_trace_tpu as gpt  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", action="store_true",
                    help="save results figure to demo_results.png")
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--n-samples", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    # 1. Synthetic test image with a known sinusoidal edge + gaps + noise.
    size = (args.size, args.size)
    test_img, true_edge = gpt.construct_test_img(
        size=size, amplitude=200, curvature=4, noise_level=0.05,
        ltype="sinusoidal", intensity=0.3, gaps=True)

    # 2. Gradient image via the extended-Sobel kernel (XLA convolution).
    kernel = gpt.kernel_builder(size=(11, 5), unit=False)
    grad_img = gpt.comp_grad_img(test_img, kernel)

    # 3. Trace the edge between the two known endpoints.
    init = true_edge[[0, -1]][:, [1, 0]]   # yx -> xy endpoints
    tracer = gpt.GP_Edge_Tracing(
        init=init, grad_img=grad_img,
        kernel_options={"kernel": "RBF", "sigma_f": 75, "length_scale": 20},
        noise_y=1, obs=np.array([]), N_samples=args.n_samples,
        score_thresh=1, delta_x=5, keep_ratio=0.1, seed=args.seed,
        return_std=True, fix_endpoints=True)

    t0 = time.perf_counter()
    edge_pred, credint = tracer()
    t1 = time.perf_counter()
    edge_pred, credint = tracer()        # steady state (compile cached)
    t2 = time.perf_counter()

    mse = float(gpt.trace_MSE(edge_pred, true_edge))
    rel = float(gpt.trace_relarea(edge_pred, true_edge))
    dice = float(gpt.trace_dicecoef(edge_pred, true_edge))
    print(f"first call (incl compile): {t1 - t0:.2f}s; "
          f"steady state: {t2 - t1:.3f}s")
    print(f"MSE: {mse:.3f}  Rel. area diff: {rel:.5f}  DICE: {dice:.4f}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        from gaussian_process_edge_trace_tpu.utils.plotting import (
            plot_results)
        fig = plot_results(edge_pred, true_edge, test_img, grad_img,
                           credint=credint, show=False)
        fig.savefig("demo_results.png", dpi=120)
        print("wrote demo_results.png")


if __name__ == "__main__":
    main()
