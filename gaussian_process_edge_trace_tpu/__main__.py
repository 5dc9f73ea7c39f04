"""Command-line interface: ``python -m gaussian_process_edge_trace_tpu``.

The reference ships no CLI (SURVEY.md §0); this is the thin serving
surface over the library: load an image (.npy or anything
``matplotlib.image.imread`` reads), optionally compute the gradient image,
trace one edge between two endpoints, write the result as ``.npz``.

Subcommands:
  trace  — trace an edge in an image file
  batch  — trace a batch of same-shaped images (vmapped; one compiled
           executable), or a warm-started sequence with --sequence
  demo   — run the synthetic README demo end to end
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_image(path):
    if str(path).endswith(".npy"):
        return np.load(path)
    import matplotlib.image as mpimg
    img = mpimg.imread(path)
    if img.ndim == 3:
        img = img[..., :3].mean(axis=-1)   # luminance
    return np.asarray(img, dtype=np.float64)


def _parse_xy(s):
    x, y = s.split(",")
    return [int(x), int(y)]


def cmd_trace(args):
    import gaussian_process_edge_trace_tpu as gpt

    img = _load_image(args.image)
    if args.is_gradient:
        grad = img
    else:
        kernel = gpt.kernel_builder(tuple(args.grad_kernel), unit=False)
        grad = gpt.comp_grad_img(img, kernel)

    init = np.asarray([_parse_xy(args.init[0]), _parse_xy(args.init[1])])
    kernel_options = {"kernel": args.kernel, "sigma_f": args.sigma_f,
                      "length_scale": args.length_scale}
    if args.kernel == "Matern":
        kernel_options["nu"] = args.nu

    tracer = gpt.GP_Edge_Tracing(
        init=init, grad_img=grad, kernel_options=kernel_options,
        noise_y=args.noise_y, obs=np.zeros((0, 2), np.int64),
        N_samples=args.n_samples, score_thresh=args.score_thresh,
        delta_x=args.delta_x, keep_ratio=args.keep_ratio,
        pixel_thresh=args.pixel_thresh, seed=args.seed, return_std=True,
        fix_endpoints=not args.free_endpoints)
    t0 = time.perf_counter()
    edge_pred, (lo, hi) = tracer()
    dt = time.perf_counter() - t0

    res = tracer.last_result
    np.savez(args.out, edge_trace=edge_pred, cred_lower=lo, cred_upper=hi,
             y_mean=np.asarray(res.y_mean),
             cred_px=np.asarray(res.cred_interval_px),
             n_iters=int(res.n_iters), theta=np.exp(np.asarray(res.theta)))
    print(json.dumps({"out": args.out, "n_iters": int(res.n_iters),
                      "converged": bool(res.converged),
                      "wall_s": round(dt, 3),
                      "lml": round(float(res.lml), 3)}))
    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 8))
        ax.imshow(np.asarray(grad), cmap="gray")
        ax.plot(edge_pred[:, 1], edge_pred[:, 0], "r-", lw=1.5)
        ax.fill_between(edge_pred[:, 1], np.asarray(res.cred_interval_px)[0],
                        np.asarray(res.cred_interval_px)[1], color="m",
                        alpha=0.3)
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}", file=sys.stderr)


def _grad_of(img, args, gpt):
    if args.is_gradient:
        return np.asarray(img)
    kernel = gpt.kernel_builder(tuple(args.grad_kernel), unit=False)
    return np.asarray(gpt.comp_grad_img(img, kernel))


def cmd_batch(args):
    """Trace every image matching the glob with ONE compiled executable
    (frames vmapped), or as a warm-started sequence (--sequence: each
    frame seeds the next frame's observations, gpet.py:57-61)."""
    import glob as globmod
    import os

    import gaussian_process_edge_trace_tpu as gpt
    from gaussian_process_edge_trace_tpu.parallel import (
        make_batch_data, make_batch_state, trace_batch_vmap,
        trace_sequence)
    from gaussian_process_edge_trace_tpu.trace.driver import make_config

    paths = sorted(globmod.glob(args.images))
    if not paths:
        raise SystemExit(f"no files match {args.images!r}")
    grads = [np.asarray(_grad_of(_load_image(p), args, gpt),
                        dtype=np.float32) for p in paths]
    shapes = {g.shape for g in grads}
    if len(shapes) != 1:
        raise SystemExit(f"images must share one shape, got {shapes}")
    grads = np.stack(grads)
    init = np.asarray([_parse_xy(args.init[0]), _parse_xy(args.init[1])])
    inits = np.broadcast_to(init, (len(paths),) + init.shape)

    kernel_options = {"kernel": args.kernel, "sigma_f": args.sigma_f,
                      "length_scale": args.length_scale}
    if args.kernel == "Matern":
        kernel_options["nu"] = args.nu
    cfg = make_config(
        init, grads.shape[1:], kernel_options=kernel_options,
        noise_y=args.noise_y, N_samples=args.n_samples,
        score_thresh=args.score_thresh, delta_x=args.delta_x,
        keep_ratio=args.keep_ratio, pixel_thresh=args.pixel_thresh,
        seed=args.seed, fix_endpoints=not args.free_endpoints)

    os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.perf_counter()
    if args.sequence:
        results = trace_sequence(cfg, grads, inits)
        per_frame = [(np.asarray(r.edge_trace), int(r.n_iters),
                      bool(r.converged)) for r in results]
    else:
        data = make_batch_data(cfg, grads, inits)
        states = make_batch_state(cfg, len(paths))
        res = trace_batch_vmap(cfg, data, states)
        per_frame = [(np.asarray(res.edge_trace[f]), int(res.n_iters[f]),
                      bool(res.converged[f])) for f in range(len(paths))]
    dt = time.perf_counter() - t0

    for p, (trace, n_it, conv) in zip(paths, per_frame):
        out = os.path.join(
            args.out_dir,
            os.path.splitext(os.path.basename(p))[0] + "_trace.npz")
        np.savez(out, edge_trace=trace)
        print(json.dumps({"image": p, "out": out, "n_iters": n_it,
                          "converged": conv}))
    print(json.dumps({"frames": len(paths), "wall_s": round(dt, 3),
                      "mode": "sequence" if args.sequence else "batch"}))


def cmd_demo(args):
    raise SystemExit("use: python examples/demo.py (from the repo root)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gaussian_process_edge_trace_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("trace", help="trace one edge in an image")
    t.add_argument("image", help=".npy or image file")
    t.add_argument("--init", nargs=2, required=True, metavar="X,Y",
                   help="two edge endpoints in xy, e.g. --init 0,250 499,250")
    t.add_argument("--is-gradient", action="store_true",
                   help="input is already a gradient image")
    t.add_argument("--grad-kernel", type=int, nargs=2, default=[11, 5])
    t.add_argument("--kernel", choices=["RBF", "Matern"], default="RBF")
    t.add_argument("--sigma-f", type=float, required=True)
    t.add_argument("--length-scale", type=float, required=True)
    t.add_argument("--nu", type=float, default=2.5)
    t.add_argument("--noise-y", type=float, default=1.0)
    t.add_argument("--n-samples", type=int, default=1000)
    t.add_argument("--score-thresh", type=float, default=1.0)
    t.add_argument("--delta-x", type=int, default=5)
    t.add_argument("--keep-ratio", type=float, default=0.1)
    t.add_argument("--pixel-thresh", type=int, default=5)
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--free-endpoints", action="store_true")
    t.add_argument("--out", default="trace_result.npz")
    t.add_argument("--plot", default=None)
    t.set_defaults(fn=cmd_trace)

    b = sub.add_parser(
        "batch", help="trace a glob of same-shaped images (vmapped), or a "
                      "warm-started sequence with --sequence")
    b.add_argument("images", help="glob of .npy/image files, e.g. "
                                  "'frames/*.npy' (quote it)")
    b.add_argument("--init", nargs=2, required=True, metavar="X,Y",
                   help="shared edge endpoints in xy")
    b.add_argument("--sequence", action="store_true",
                   help="warm-start each frame from the previous frame's "
                        "accepted observations")
    b.add_argument("--is-gradient", action="store_true")
    b.add_argument("--grad-kernel", type=int, nargs=2, default=[11, 5])
    b.add_argument("--kernel", choices=["RBF", "Matern"], default="RBF")
    b.add_argument("--sigma-f", type=float, required=True)
    b.add_argument("--length-scale", type=float, required=True)
    b.add_argument("--nu", type=float, default=2.5)
    b.add_argument("--noise-y", type=float, default=1.0)
    b.add_argument("--n-samples", type=int, default=1000)
    b.add_argument("--score-thresh", type=float, default=1.0)
    b.add_argument("--delta-x", type=int, default=5)
    b.add_argument("--keep-ratio", type=float, default=0.1)
    b.add_argument("--pixel-thresh", type=int, default=5)
    b.add_argument("--seed", type=int, default=42)
    b.add_argument("--free-endpoints", action="store_true")
    b.add_argument("--out-dir", default="traces")
    b.set_defaults(fn=cmd_batch)

    d = sub.add_parser("demo", help="pointer to examples/demo.py")
    d.set_defaults(fn=cmd_demo)

    args = ap.parse_args(argv)
    from gaussian_process_edge_trace_tpu.utils.cache import (
        enable_compilation_cache)
    enable_compilation_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
