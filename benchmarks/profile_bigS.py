"""Per-op device breakdown of the large-S traces (1000x1000 image,
S = 10⁴ and 10⁵ posterior samples by default), from a profiler trace of
one call, so the next optimisation target is chosen from the device
timeline.

Run on the GPU: ``python -m benchmarks.profile_bigS [S ...]``.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from gaussian_process_edge_trace_tpu.utils.cache import (
        enable_compilation_cache)
    enable_compilation_cache()

    import gaussian_process_edge_trace_tpu as gpt
    from benchmarks.suite import _device_ms
    from gaussian_process_edge_trace_tpu.trace.driver import (
        init_state, make_config, make_data, run_trace)
    from gaussian_process_edge_trace_tpu.utils.profiling import (
        device_op_breakdown)

    log("devices:", jax.devices())

    sizes = [int(a) for a in sys.argv[1:]] or [10000, 100000]

    img, edge = gpt.construct_test_img((1000, 1000), 400, 4, 0.05,
                                       "sinusoidal", 0.3, gaps=True)
    kb = gpt.kernel_builder((11, 5), unit=False)
    grad = gpt.comp_grad_img(jnp.asarray(img), kb)
    init = edge[[0, -1]][:, [1, 0]]

    for S in sizes:
        cfg = make_config(
            init, (1000, 1000),
            kernel_options={"kernel": "RBF", "sigma_f": 200,
                            "length_scale": 50},
            noise_y=1, N_samples=S, score_thresh=1, delta_x=5,
            keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)
        data = make_data(cfg, grad, jnp.asarray(init))
        state0 = init_state(cfg)
        import time
        t0 = time.time()
        r = run_trace(cfg, data, state0)
        iters = int(np.asarray(r.n_iters))
        log(f"S={S}: first call (incl compile) {time.time()-t0:.1f}s, "
            f"{iters} iters")
        t0 = time.time()
        ms = _device_ms(run_trace, cfg, data, state0)
        log(f"S={S}: {ms:.1f} ms device (_device_ms took "
            f"{time.time()-t0:.1f}s host)")
        rows = device_op_breakdown(run_trace, cfg, data, state0, top=40)
        total = ms
        out = {"config": f"profile_1000_S{S}", "device_ms": round(ms, 1),
               "iters": iters,
               "ops": [{"ms": round(m, 2), "pct": round(100 * m / total, 1),
                        "name": n} for m, n in rows]}
        print(json.dumps(out), flush=True)
        for m, n in rows[:25]:
            log(f"  {m:9.2f} ms {100*m/total:5.1f}%  {n}")


if __name__ == "__main__":
    main()
