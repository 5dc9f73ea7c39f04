"""Sharded benchmark row: BASELINE config-4 shape driven through
``sharded_trace_batch`` on a (data, sample) mesh, with the collective
footprint extracted from the compiled HLO.

Runs standalone on a virtual CPU mesh of the mesh's size:
``python -m benchmarks.sharded_row [--mesh 2,4] [--size 128]
[--n-samples 512] [--frames 4]``. The suite invokes it as a subprocess
and merges its JSON line.

The wall-clock on a virtual CPU mesh is NOT a device number — the row's
value is (a) the sharded program compiles and runs on a real multi-device
mesh topology, and (b) the communication volume is pinned: per outer
iteration the sp axis needs exactly ONE all-gather of the (S,) cost
vector and ONE psum of the (E, N_keep) extracted-curve matrix
(trace/driver.py::_iteration); everything else is replicated compute.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time


def _provision_cpu_mesh(n_devices: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
    os.environ["XLA_FLAGS"] = (
        flags + f" --xla_force_host_platform_device_count={n_devices}"
    ).strip()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2,4")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--n-samples", type=int, default=512)
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args(argv)
    n_data, n_sample = (int(v) for v in args.mesh.split(","))
    _provision_cpu_mesh(n_data * n_sample)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import gaussian_process_edge_trace_tpu as gpt
    from gaussian_process_edge_trace_tpu.parallel import (
        make_batch_data, make_batch_state, make_mesh, sharded_trace_batch)
    from gaussian_process_edge_trace_tpu.trace.driver import make_config

    M = N = args.size
    grads, inits = [], []
    for f in range(args.frames):
        img, edge = gpt.construct_test_img(
            size=(M, N), amplitude=M // 3, curvature=2, noise_level=0.02,
            ltype="sinusoidal", intensity=0.3, gaps=False, seed=f + 1)
        grads.append(np.asarray(
            gpt.comp_grad_img(img, gpt.kernel_builder((7, 3))),
            dtype=np.float32))
        inits.append([[0, edge[0, 0]], [N - 1, edge[N - 1, 0]]])
    grads = np.stack(grads)
    inits = np.asarray(inits)

    cfg = make_config(
        inits[0], (M, N),
        kernel_options={"kernel": "RBF", "sigma_f": M // 4,
                        "length_scale": N // 12},
        noise_y=1, N_samples=args.n_samples, score_thresh=0.5, delta_x=6,
        keep_ratio=0.1, pixel_thresh=4, seed=1, fix_endpoints=True)
    data = make_batch_data(cfg, grads, inits)
    states = make_batch_state(cfg, args.frames)
    mesh = make_mesh(n_data, n_sample)

    # Collective footprint from the compiled HLO.
    lowered = jax.jit(
        lambda d, s: sharded_trace_batch(cfg, d, s, mesh,
                                         n_frames=args.frames)).lower(
                                             data, states)
    hlo = lowered.compile().as_text()
    collectives = {
        "all_gather": len(re.findall(r"\ball-gather(?:-start)?\(", hlo)),
        "all_reduce": len(re.findall(r"\ball-reduce(?:-start)?\(", hlo)),
        "collective_permute": len(
            re.findall(r"\bcollective-permute(?:-start)?\(", hlo)),
        "all_to_all": len(re.findall(r"\ball-to-all\(", hlo)),
    }

    res = jax.block_until_ready(
        sharded_trace_batch(cfg, data, states, mesh, n_frames=args.frames))
    t0 = time.perf_counter()
    res = jax.block_until_ready(
        sharded_trace_batch(cfg, data, states, mesh, n_frames=args.frames))
    ms = (time.perf_counter() - t0) * 1e3

    row = {
        "config": f"sharded_{M}x{N}_S{args.n_samples}_mesh{n_data}x"
                  f"{n_sample}",
        "value": round(ms, 2),
        "unit": "ms (virtual CPU mesh — topology/communication check, "
                "not device perf)",
        "devices": n_data * n_sample,
        "frames": args.frames,
        "converged": bool(np.all(np.asarray(res.converged))),
        "iters": np.asarray(res.n_iters).tolist(),
        "collectives": collectives,
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
