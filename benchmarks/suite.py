"""Benchmark suite: the five BASELINE.json configs on the local device.

Run: ``python -m benchmarks.suite [--quick]``. Prints one JSON line per
config (machine-parsable) plus a human-readable table to stderr.
bench.py remains the single headline metric; this suite covers the rest.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _device_ms(fn, *args):
    """Device time of one ``fn(*args)`` call: the time in which any of its
    kernels ran (utils/profiling.py::device_span). The span from first to
    last kernel is not used: the profiler stretches the gaps of a program
    of many short kernels, so a traced span can exceed the untraced wall."""
    from gaussian_process_edge_trace_tpu.utils.profiling import device_span
    return device_span(fn, *args).busy_ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default="",
                    help="substring filter on config tags (config 1, the "
                         "demo trace, always runs — later rows reuse its "
                         "state)")
    args = ap.parse_args()

    def want(tag):
        return (not args.only) or (args.only in tag)

    import jax
    import jax.numpy as jnp

    import gaussian_process_edge_trace_tpu as gpt
    from gaussian_process_edge_trace_tpu.trace.driver import (
        finish_trace, init_state, make_config, make_data, run_trace,
        trace_step)
    from gaussian_process_edge_trace_tpu.parallel import trace_sequence

    log("devices:", jax.devices())
    results = []

    def emit(name, ms, **extra):
        row = {"config": name, "value": round(ms, 2), "unit": "ms", **extra}
        results.append(row)
        print(json.dumps(row), flush=True)

    # ---- config 1: README demo trace (same as bench.py) ------------------
    test_img, true_edge = gpt.construct_test_img(
        (500, 500), 200, 4, 0.05, "sinusoidal", 0.3, gaps=True)
    kb = gpt.kernel_builder((11, 5), unit=False)
    grad = gpt.comp_grad_img(jnp.asarray(test_img), kb)
    init = true_edge[[0, -1]][:, [1, 0]]
    cfg = make_config(init, (500, 500),
                      kernel_options={"kernel": "RBF", "sigma_f": 75,
                                      "length_scale": 20},
                      noise_y=1, N_samples=1000, score_thresh=1, delta_x=5,
                      keep_ratio=0.1, pixel_thresh=5, seed=1,
                      fix_endpoints=True)
    data = make_data(cfg, grad, jnp.asarray(init))
    ms = _device_ms(run_trace, cfg, data, init_state(cfg))
    res = run_trace(cfg, data, init_state(cfg))
    from benchmarks.flops import device_peak_flops, trace_flops

    def _mfu(cfg_, res_, ms_):
        fl = trace_flops(cfg_, int(res_.n_iters))["total"]
        return {"gflops": round(fl / 1e9, 2),
                "mfu": round(fl / (ms_ / 1e3) / device_peak_flops(), 5)}

    emit("1_demo_trace_500", ms,
         mse=float(gpt.trace_MSE(np.asarray(res.edge_trace), true_edge)),
         dice=float(gpt.trace_dicecoef(np.asarray(res.edge_trace),
                                       true_edge)),
         **_mfu(cfg, res, ms))

    # ---- config 1b: batched serving throughput (B frames / dispatch) ------
    # The reference traces one image per call (gpet.py:768); the framework
    # serves B complete traces per dispatch via vmap.
    from gaussian_process_edge_trace_tpu.parallel.sharded import (
        make_batch_data, make_batch_state, trace_batch_vmap)

    def batch_frames(B):
        gs, ins, eds = [], [], []
        for s in range(B):
            im, ed = gpt.construct_test_img(
                (500, 500), 200, 4, 0.05, "sinusoidal", 0.3, gaps=True,
                seed=1 + s)
            gs.append(np.asarray(gpt.comp_grad_img(jnp.asarray(im), kb)))
            ins.append(ed[[0, -1]][:, [1, 0]])
            eds.append(ed)
        return np.stack(gs), np.stack(ins), eds

    for B in ((  [16] if args.quick else [4, 16, 64])
              if want("1b") else []):
        gs, ins, eds = batch_frames(B)
        cfgb = make_config(ins[0], (500, 500),
                           kernel_options={"kernel": "RBF", "sigma_f": 75,
                                           "length_scale": 20},
                           noise_y=1, N_samples=1000, score_thresh=1,
                           delta_x=5, keep_ratio=0.1, pixel_thresh=5,
                           seed=1, fix_endpoints=True)
        datab = make_batch_data(cfgb, gs, ins)
        statesb = make_batch_state(cfgb, B)
        ms = _device_ms(trace_batch_vmap, cfgb, datab, statesb)
        rb = trace_batch_vmap(cfgb, datab, statesb)
        dice_b = [float(gpt.trace_dicecoef(
            np.asarray(rb.edge_trace)[f], eds[f])) for f in range(B)]
        # Within each _BATCH_TILE-frame chunk the while_loop runs until
        # the chunk's slowest frame converges (tiled lax.map batcher) —
        # emit the iteration spread to attribute B-dependence.
        it_b = np.asarray(rb.n_iters).astype(int)
        emit(f"1b_batch_serving_B{B}", ms / B,
             total_ms=round(ms, 1),
             traces_per_s=round(B / (ms / 1e3), 1),
             dice_median=round(float(np.median(dice_b)), 4),
             iters_median=int(np.median(it_b)),
             iters_max=int(it_b.max()))

    # ---- config 1d: serving throughput ceiling ----------------------------
    # Where does per-card throughput saturate? Sweep the batch width with
    # a tile-width A/B at each point, then emit the peak traces/s per card
    # + device MFU at saturation.
    if not args.quick and want("1d"):
        import gaussian_process_edge_trace_tpu.parallel.sharded as _sh

        saved_tile = _sh._BATCH_TILE
        peak = None
        try:
            for B in [64, 128, 256]:
                gs, ins, eds = batch_frames(B)
                cfgd = make_config(
                    ins[0], (500, 500),
                    kernel_options={"kernel": "RBF", "sigma_f": 75,
                                    "length_scale": 20},
                    noise_y=1, N_samples=1000, score_thresh=1, delta_x=5,
                    keep_ratio=0.1, pixel_thresh=5, seed=1,
                    fix_endpoints=True)
                datad = make_batch_data(cfgd, gs, ins)
                statesd = make_batch_state(cfgd, B)
                for tile in (8, 16):
                    _sh._BATCH_TILE = tile
                    jax.clear_caches()   # _BATCH_TILE is read at trace time
                    ms = _device_ms(trace_batch_vmap, cfgd, datad, statesd)
                    rb = trace_batch_vmap(cfgd, datad, statesd)
                    dice_b = float(np.median([gpt.trace_dicecoef(
                        np.asarray(rb.edge_trace)[f], eds[f])
                        for f in range(B)]))
                    fl = sum(trace_flops(cfgd, int(i))["total"]
                             for i in np.asarray(rb.n_iters))
                    tps = B / (ms / 1e3)
                    mfu = fl / (ms / 1e3) / device_peak_flops()
                    emit(f"1d_throughput_B{B}_tile{tile}", ms / B,
                         total_ms=round(ms, 1),
                         traces_per_s=round(tps, 1),
                         device_mfu=round(mfu, 5),
                         dice_median=round(dice_b, 4))
                    if peak is None or tps > peak["traces_per_s"]:
                        peak = {"B": B, "tile": tile,
                                "traces_per_s": round(tps, 1),
                                "ms_per_trace": round(ms / B, 3),
                                "device_mfu": round(mfu, 5)}
        finally:
            _sh._BATCH_TILE = saved_tile
            jax.clear_caches()
        results.append({"config": "1d_peak_throughput", **peak})
        print(json.dumps(results[-1]), flush=True)

    # ---- config 2: preprocessing sweep ------------------------------------
    for ksz in ([(5, 3), (11, 5), (15, 7)] if want("2_") else []):
        k = gpt.kernel_builder(ksz, unit=False)  # host constant
        f = (lambda kk: (lambda im: gpt.comp_grad_img(im, kk)))(k)
        ms = _device_ms(f, jnp.asarray(test_img))
        emit(f"2_grad_img_500_k{ksz[0]}x{ksz[1]}", ms)

    # ---- config 3: hyperparameter-optimisation path -----------------------
    if want("3_"):
        state = init_state(cfg)
        for _ in range(int(res.n_iters)):
            state, _ = trace_step(cfg, data, state)
        ms = _device_ms(finish_trace, cfg, data, state)
        emit("3_lml_optimisation_13starts", ms,
             lml=float(res.lml))

    # ---- config 4: scaled posterior sampling at 1000x1000 ----------------
    big_img, big_edge = gpt.construct_test_img(
        (1000, 1000), 400, 4, 0.05, "sinusoidal", 0.3, gaps=True)
    big_grad = gpt.comp_grad_img(jnp.asarray(big_img), kb)
    big_init = big_edge[[0, -1]][:, [1, 0]]
    for n_samples in (([1000] if args.quick else [1000, 10000])
                      if want("4_") else []):
        cfg4 = make_config(
            big_init, (1000, 1000),
            kernel_options={"kernel": "RBF", "sigma_f": 200,
                            "length_scale": 50},
            noise_y=1, N_samples=n_samples, score_thresh=1, delta_x=5,
            keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)
        data4 = make_data(cfg4, big_grad, jnp.asarray(big_init))
        ms = _device_ms(run_trace, cfg4, data4, init_state(cfg4))
        r4 = run_trace(cfg4, data4, init_state(cfg4))
        emit(f"4_trace_1000_S{n_samples}", ms,
             mse=float(gpt.trace_MSE(np.asarray(r4.edge_trace), big_edge)),
             iters=int(r4.n_iters), **_mfu(cfg4, r4, ms))

    # ---- config 1c: best-of-5 seed ensemble (one dispatch) ----------------
    # trace_ensemble clips the algorithm's long seed tail by running K
    # complete traces vmapped over member keys and keeping the
    # argmin-final-cost one (the cost rank-orders seed quality; BASELINE).
    from gaussian_process_edge_trace_tpu.parallel import trace_ensemble

    if want("1c"):
        st0 = init_state(cfg)
        ems = _device_ms(trace_ensemble, cfg, data, st0, 5)
        ebest = trace_ensemble(cfg, data, st0, n_seeds=5)
        emit("1c_ensemble_best_of_5", ems,
             dice=float(gpt.trace_dicecoef(np.asarray(ebest.edge_trace),
                                           true_edge)),
             final_cost=float(ebest.final_cost))

    # ---- config 4b: 2000x2000 stretch (next size octave) ------------------
    # Exercises the n_train=408 coarse-to-fine fit and the shifted-FMA KDE
    # blur end-to-end.
    if not args.quick and want("4b"):
        img2k, edge2k = gpt.construct_test_img(
            (2000, 2000), 700, 4, 0.05, "sinusoidal", 0.3, gaps=True)
        grad2k = gpt.comp_grad_img(jnp.asarray(img2k), kb)
        init2k = edge2k[[0, -1]][:, [1, 0]]
        cfg2k = make_config(
            init2k, (2000, 2000),
            kernel_options={"kernel": "RBF", "sigma_f": 400,
                            "length_scale": 100},
            noise_y=1, N_samples=1000, score_thresh=1, delta_x=5,
            keep_ratio=0.1, pixel_thresh=5, seed=1, fix_endpoints=True)
        data2k = make_data(cfg2k, grad2k, jnp.asarray(init2k))
        ms = _device_ms(run_trace, cfg2k, data2k, init_state(cfg2k))
        r2k = run_trace(cfg2k, data2k, init_state(cfg2k))
        emit("4b_trace_2000_S1000", ms,
             dice=float(gpt.trace_dicecoef(np.asarray(r2k.edge_trace),
                                           edge2k)),
             iters=int(r2k.n_iters), **_mfu(cfg2k, r2k, ms))

    # ---- config 4c: non-square orientations (per-axis blur gate) ----------
    # The reference traces any (M, N) (gpet.py:97). 1536 crosses the
    # _BLUR_MATMUL_MAX=600 gate so the long axis blurs as shifted FMAs
    # while the short one stays a Toeplitz matmul — both orientations
    # exercise the (E, M) grad-column vs (M, N) KDE axis handling.
    if not args.quick and want("4c"):
        # Config picked by a CPU sweep: the tall orientation needs a
        # gentle edge slope — amp=500 @ curvature 4 over 512 columns is a
        # ~25 px/px near-vertical edge that NO y(x) tracer (reference
        # included) can follow (MSE ~1e5); amp=150 traces to MSE ~1.6.
        for (Mns, Nns, amp, sf, ls) in [(512, 1536, 150, 100, 60),
                                        (1536, 512, 150, 100, 30)]:
            imgns, edgens = gpt.construct_test_img(
                (Mns, Nns), amp, 4, 0.05, "sinusoidal", 0.3, gaps=True)
            gradns = gpt.comp_grad_img(jnp.asarray(imgns), kb)
            initns = edgens[[0, -1]][:, [1, 0]]
            cfgns = make_config(
                initns, (Mns, Nns),
                kernel_options={"kernel": "RBF", "sigma_f": sf,
                                "length_scale": ls},
                noise_y=1, N_samples=1000, score_thresh=1, delta_x=5,
                keep_ratio=0.1, pixel_thresh=5, seed=1,
                fix_endpoints=True)
            datans = make_data(cfgns, gradns, jnp.asarray(initns))
            ms = _device_ms(run_trace, cfgns, datans, init_state(cfgns))
            rns = run_trace(cfgns, datans, init_state(cfgns))
            emit(f"4c_trace_{Mns}x{Nns}_S1000", ms,
                 mse=float(gpt.trace_MSE(np.asarray(rns.edge_trace),
                                         edgens)),
                 iters=int(rns.n_iters))

    # ---- config 5: warm-started frame sequence ----------------------------
    if want("5_"):
        rngf = np.random.RandomState(0)
        frames, inits = [], []
        n_frames = 3
        base_img, base_edge = gpt.construct_test_img(
            (500, 500), 200, 4, 0.03, "sinusoidal", 0.3, gaps=False)
        for f_i in range(n_frames):
            img = np.clip(base_img
                          + rngf.normal(0, 0.02, base_img.shape), 0, 1)
            frames.append(np.asarray(
                gpt.comp_grad_img(jnp.asarray(img), kb)))
            inits.append(base_edge[[0, -1]][:, [1, 0]])
        cfg5 = make_config(inits[0], (500, 500),
                           kernel_options={"kernel": "RBF", "sigma_f": 75,
                                           "length_scale": 20},
                           noise_y=1, N_samples=1000, score_thresh=1,
                           delta_x=5, keep_ratio=0.1, pixel_thresh=5,
                           seed=1, fix_endpoints=True)
        trace_sequence(cfg5, frames, inits)   # compile warm+cold configs
        t0 = time.perf_counter()
        seq = trace_sequence(cfg5, frames, inits)
        seq_ms = (time.perf_counter() - t0) * 1e3
        emit("5_sequence_3frames_warmstart", seq_ms,
             iters=[int(r.n_iters) for r in seq],
             mse=[float(gpt.trace_MSE(np.asarray(r.edge_trace),
                                      base_edge))
                  for r in seq])

    # ---- config 6: sharded dp x sp row (virtual mesh subprocess) ----------
    # Runs benchmarks/sharded_row.py in a child process on an 8-device
    # virtual CPU mesh. The child keeps JAX_PLATFORMS=cpu: this process
    # holds the GPU, and a second JAX process on the card would fail for
    # want of memory. Pins the sharded program's collective footprint
    # from the compiled HLO.
    if want("6_"):
        import subprocess

        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "-m", "benchmarks.sharded_row"],
            capture_output=True, text=True, env=env,
            cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
        emitted = False
        for line in proc.stdout.splitlines():
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            results.append(row)
            print(json.dumps(row), flush=True)
            emitted = True
        if not emitted:
            log("sharded row failed:", proc.returncode,
                proc.stderr[-2000:])

    log("\nsummary:")
    for r in results:
        log(" ", r)


if __name__ == "__main__":
    main()
