"""Headline benchmark: one 500×500 edge trace (README demo config,
BASELINE.json config 1) on the local GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}
where ``value`` is the wall time of one trace in milliseconds — the host
clock around an untraced call that ends in ``block_until_ready``, median
of 5 — and ``vs_baseline`` is the speedup over the CPU reference
implementation (benchmarks/reference_cpu.py, the reference algorithm
measured on this machine's host). The device's own times come from one
call under the profiler (utils/profiling.py::device_span) and are
diagnostics: ``device_busy_ms``, the time any kernel ran, which cannot
exceed the untraced wall; and ``device_span_ms``, first kernel to last,
which the profiler stretches for a program of many short kernels, so it
is held only to the wall of that traced call. Every row names the device
it ran on. Diagnostics go to stderr.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from gaussian_process_edge_trace_tpu.utils.cache import (
        enable_compilation_cache)
    log(f"compilation cache: {enable_compilation_cache()}")

    import gaussian_process_edge_trace_tpu as gpt
    from benchmarks.flops import device_peak_flops, trace_flops
    from gaussian_process_edge_trace_tpu.trace.driver import (
        init_state, make_config, make_data, run_trace)
    from gaussian_process_edge_trace_tpu.utils.profiling import device_span

    dev = jax.devices()[0]
    peak = device_peak_flops()      # raises on a device with no known peak
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("devices:", jax.devices(), "| card:", card)

    # README demo config (README.md:46-84).
    test_img, true_edge = gpt.construct_test_img(
        (500, 500), 200, 4, 0.05, "sinusoidal", 0.3, gaps=True)
    kernel = gpt.kernel_builder((11, 5), unit=False)
    grad = np.asarray(gpt.comp_grad_img(test_img, kernel), dtype=np.float64)
    init = true_edge[[0, -1]][:, [1, 0]]
    ko = {"kernel": "RBF", "sigma_f": 75, "length_scale": 20}
    kw = dict(noise_y=1, N_samples=1000, score_thresh=1, delta_x=5,
              keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)

    # --- one trace: first call, steady wall, device span ------------------
    cfg = make_config(init, grad.shape, kernel_options=ko, **kw)
    data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
    state0 = init_state(cfg)
    t0 = time.perf_counter()
    res = jax.block_until_ready(run_trace(cfg, data, state0))
    first_call_s = time.perf_counter() - t0
    log(f"first call (incl compile): {first_call_s:.2f}s")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        res = jax.block_until_ready(run_trace(cfg, data, state0))
        times.append(time.perf_counter() - t0)
    wall_ms = float(np.median(times) * 1e3)
    pred = np.asarray(res.edge_trace)
    mse = float(gpt.trace_MSE(pred, true_edge))
    dice = float(gpt.trace_dicecoef(pred, true_edge))
    dt = device_span(run_trace, cfg, data, state0)
    log(f"trace: wall {wall_ms:.3f} ms, device span {dt.span_ms:.3f} ms "
        f"(busy {dt.busy_ms:.3f}, traced-call wall {dt.wall_ms:.3f}) "
        f"iters={int(res.n_iters)} MSE={mse:.2f} DICE={dice:.4f}")

    assert dt.span_ms <= dt.wall_ms, (
        f"device span {dt.span_ms} ms > traced-call wall {dt.wall_ms} ms")
    assert dt.busy_ms <= wall_ms, (
        f"device busy {dt.busy_ms} ms > untraced wall {wall_ms} ms")

    # --- FLOP accounting against the card's published bf16 peak ----------
    fl = trace_flops(cfg, int(res.n_iters))
    dev_mfu = fl["total"] / (wall_ms / 1e3) / peak
    log(f"flops: {fl['total'] / 1e9:.3f} GFLOP/trace -> "
        f"{100 * dev_mfu:.4f}% of {peak / 1e12:.0f} TFLOP/s")

    # --- multi-seed accuracy (gate on the median, not one lucky seed) -----
    per_seed = [{"seed": cfg.seed, "mse": round(mse, 2),
                 "dice": round(dice, 4), "iters": int(res.n_iters)}]
    for extra_seed in (2, 3):
        r = jax.block_until_ready(
            run_trace(cfg, data, state0, jax.random.PRNGKey(extra_seed)))
        p = np.asarray(r.edge_trace)
        per_seed.append({
            "seed": extra_seed,
            "mse": round(float(gpt.trace_MSE(p, true_edge)), 2),
            "dice": round(float(gpt.trace_dicecoef(p, true_edge)), 4),
            "iters": int(r.n_iters)})
    dices = sorted(s["dice"] for s in per_seed)
    median_dice = dices[len(dices) // 2]
    log(f"per-seed: {per_seed}  median DICE={median_dice:.4f}")

    # --- best-of-5 seed ensemble (one dispatch; clips the seed tail) ------
    from gaussian_process_edge_trace_tpu.parallel import trace_ensemble
    eb = jax.block_until_ready(trace_ensemble(cfg, data, state0, n_seeds=5))
    ens_dice = float(gpt.trace_dicecoef(np.asarray(eb.edge_trace),
                                        true_edge))
    log(f"best-of-5 ensemble: DICE={ens_dice:.4f} "
        f"cost={float(eb.final_cost):.4f}")

    # --- batched serving throughput (B=16 frames in ONE dispatch) ---------
    from gaussian_process_edge_trace_tpu.parallel.sharded import (
        make_batch_data, make_batch_state, trace_batch_vmap)
    B = 16
    gs, ins, eds = [], [], []
    for s in range(B):
        im, ed = gpt.construct_test_img(
            (500, 500), 200, 4, 0.05, "sinusoidal", 0.3, gaps=True,
            seed=1 + s)
        gs.append(np.asarray(gpt.comp_grad_img(im, kernel), np.float64))
        ins.append(ed[[0, -1]][:, [1, 0]])
        eds.append(ed)
    datab = make_batch_data(cfg, np.stack(gs), np.stack(ins))
    statesb = make_batch_state(cfg, B)
    rb = jax.block_until_ready(trace_batch_vmap(cfg, datab, statesb))
    bt = []
    for _ in range(3):
        t0 = time.perf_counter()
        rb = jax.block_until_ready(trace_batch_vmap(cfg, datab, statesb))
        bt.append(time.perf_counter() - t0)
    batch_s = float(np.median(bt))
    batch_dice = sorted(float(gpt.trace_dicecoef(
        np.asarray(rb.edge_trace)[f], eds[f])) for f in range(B))
    bdt = device_span(trace_batch_vmap, cfg, datab, statesb)
    batch_flops = sum(trace_flops(cfg, int(i))["total"]
                      for i in np.asarray(rb.n_iters))
    batch_mfu = batch_flops / batch_s / peak
    assert bdt.busy_ms <= batch_s * 1e3, (bdt.busy_ms, batch_s)
    log(f"batch B={B}: wall {batch_s * 1e3:.2f} ms "
        f"({batch_s * 1e3 / B:.3f} ms/trace, {B / batch_s:.1f} traces/s), "
        f"device span {bdt.span_ms:.2f} ms, busy {bdt.busy_ms:.2f} ms, "
        f"DICE median={batch_dice[B // 2]:.4f}")

    # --- CPU reference baseline ------------------------------------------
    from benchmarks.reference_cpu import ReferenceTracerCPU
    t0 = time.perf_counter()
    ref = ReferenceTracerCPU(init, grad, ko, **kw)
    ref_edge, _, ref_iters = ref()
    ref_ms = (time.perf_counter() - t0) * 1e3
    ref_dice = float(gpt.trace_dicecoef(ref_edge, true_edge))
    log(f"cpu reference: {ref_ms:.1f} ms  iters={ref_iters} "
        f"DICE={ref_dice:.4f}")

    # Regression gates: the 3-seed median catches regressions a single
    # lucky seed would hide; the per-seed floor catches breakage.
    assert median_dice > 0.985, \
        f"accuracy regression: median DICE {median_dice} ({per_seed})"
    assert min(dices) > 0.97, f"accuracy regression: seed DICEs {per_seed}"

    print(json.dumps({
        "metric": "trace_500x500_wall_ms",
        "value": round(wall_ms, 3),
        "unit": "ms",
        "vs_baseline": round(ref_ms / wall_ms, 1),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "device_span_ms": round(dt.span_ms, 3),
        "device_busy_ms": round(dt.busy_ms, 3),
        "traced_wall_ms": round(dt.wall_ms, 3),
        "first_call_s": round(first_call_s, 2),
        "gflops_per_trace": round(fl["total"] / 1e9, 3),
        "mfu": round(dev_mfu, 6),
        "per_seed": per_seed,
        "median_dice": median_dice,
        "batch16_wall_ms_per_trace": round(batch_s * 1e3 / B, 3),
        "batch16_device_busy_ms_per_trace": round(bdt.busy_ms / B, 3),
        "batch16_mfu": round(batch_mfu, 6),
        "batch16_traces_per_s": round(B / batch_s, 1),
        "batch16_dice_median": round(batch_dice[B // 2], 4),
        "ensemble5_dice": round(ens_dice, 4),
    }))


if __name__ == "__main__":
    main()
