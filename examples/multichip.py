"""Multi-device tracing: frames data-parallel x posterior samples
sample-parallel over a (data, sample) mesh.

On a multi-GPU host it uses the cards directly and fails when there are
fewer than the mesh needs. ``--cpu-mesh`` runs it instead on a virtual
CPU mesh of that size (the same recipe as tests/conftest.py). Because
every posterior draw is keyed by its global sample index, the selection
pipeline runs replicated and each shard traces at the single-device batch
width, the sharded result reproduces the single-device trajectory exactly
(PARITY.md).

Run: ``python examples/multichip.py [--mesh 2,2] [--frames 4] [--cpu-mesh]``.
"""

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def provision(n_devices: int) -> None:
    """Ask for a virtual CPU mesh of ``n_devices`` (before jax imports)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n_devices}"
    ).strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2,2",
                    help="data,sample mesh shape (product = device count)")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--cpu-mesh", action="store_true",
                    help="run on a virtual CPU mesh of the mesh's size")
    args = ap.parse_args()
    n_data, n_sample = (int(v) for v in args.mesh.split(","))
    if args.cpu_mesh:
        provision(n_data * n_sample)

    import jax

    if len(jax.devices()) < n_data * n_sample:
        raise SystemExit(
            f"mesh {args.mesh} needs {n_data * n_sample} devices, found "
            f"{len(jax.devices())} {jax.devices()[0].platform} device(s); "
            "pass --cpu-mesh for a virtual CPU mesh")

    import numpy as np

    import gaussian_process_edge_trace_tpu as gpt
    from gaussian_process_edge_trace_tpu.parallel import (
        make_batch_data, make_batch_state, make_mesh, sharded_trace_batch)
    from gaussian_process_edge_trace_tpu.trace.driver import make_config

    M = N = args.size
    grads, inits, edges = [], [], []
    for f in range(args.frames):
        img, edge = gpt.construct_test_img(
            size=(M, N), amplitude=M // 3, curvature=2, noise_level=0.02,
            ltype="sinusoidal", intensity=0.3, gaps=False, seed=f + 1)
        grads.append(np.asarray(
            gpt.comp_grad_img(img, gpt.kernel_builder((7, 3))),
            dtype=np.float32))
        inits.append([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
        edges.append(edge[:N])

    cfg = make_config(
        np.asarray(inits[0]), (M, N),
        kernel_options={"kernel": "RBF", "sigma_f": M // 4,
                        "length_scale": N // 12},
        noise_y=1, N_samples=128 * n_sample, score_thresh=0.5, delta_x=6,
        keep_ratio=0.1, pixel_thresh=4, seed=1, fix_endpoints=True)
    data = make_batch_data(cfg, np.stack(grads), np.asarray(inits))
    states = make_batch_state(cfg, args.frames)
    mesh = make_mesh(n_data, n_sample,
                     devices=jax.devices()[:n_data * n_sample])
    print(f"mesh: {mesh.shape} over {jax.devices()[0].platform} devices")

    res = jax.device_get(
        sharded_trace_batch(cfg, data, states, mesh, n_frames=args.frames))
    for f in range(args.frames):
        mse = float(gpt.trace_MSE(res.edge_trace[f], edges[f]))
        print(f"frame {f}: converged={bool(res.converged[f])} "
              f"iters={int(res.n_iters[f])} MSE={mse:.2f}")


if __name__ == "__main__":
    main()
