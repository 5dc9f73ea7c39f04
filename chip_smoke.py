"""Smoke run of the edge tracer on an NVIDIA GPU.

Drives the main path through the entry points a user calls, at the sizes
the paper's users run, on synthetic images made from fixed seeds, and
checks each result by the repository's own accuracy gates:

1. device check (a GPU is required; there is no CPU fallback);
2. the two GPU kernels (curve cost, posterior draw) against their plain
   ``jnp`` references at the widths of phases 3-5, and the bitwise
   independence of each sample's result from the draw width;
3. the README demo through ``GP_Edge_Tracing`` (500x500, S=1000), seeds
   1-3;
4. 16 distinct 500x500 frames through ``trace_batch_vmap``;
5. a 1000x1000 image through ``run_trace`` at S=10^4 and S=10^5;
6. the CLI ``trace`` subcommand, called in-process on a ``.npy`` image.

With ``--devices 4`` it runs only the sharded phase instead:
``sharded_trace_batch`` on (1,4), (2,2) and (4,1) meshes against
``trace_batch_vmap`` over the whole batch on one card.

Every phase prints its first-call time (compilation included), its
steady-state time (median of 5) and its accuracy beside the card's name
and power limit. A failing check raises, so the script exits non-zero.
The last line of standard output is one JSON object naming the device.

Run from the repository root: ``python3 chip_smoke.py [--devices 4]``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEMO_KO = {"kernel": "RBF", "sigma_f": 75, "length_scale": 20}
DEMO_KW = dict(noise_y=1, N_samples=1000, score_thresh=1, delta_x=5,
               keep_ratio=0.1, pixel_thresh=5, fix_endpoints=True)
BIG_KO = {"kernel": "RBF", "sigma_f": 200, "length_scale": 50}

# Curve costs are f32 sums over ~E/2 Simpson pairs that the kernel adds
# in another order than XLA: only reassociation separates the two, which
# moves a cost by a few ulps per pair (measured ~2e-6 relative at
# 1000x1000).
COST_RTOL = 1e-4
# The draw kernel contracts in TF32 (10-bit mantissa inputs, f32
# accumulation); against an f32 reference its error is ~2^-11 of the
# terms it sums, so it is measured against the largest deviation of the
# draws from their mean c.
DRAW_TOL = 2e-3


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def timed(fn, n=5):
    """First-call seconds and the median of ``n`` further calls, in ms.
    ``fn`` must block until its device work is done."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return out, first, float(np.median(ts)) * 1e3


def report(phase, card_id, first_s, steady_ms, **extra):
    print(json.dumps({"phase": phase, "card": card_id,
                      "first_call_s": round(first_s, 3),
                      "steady_ms": (None if steady_ms is None
                                    else round(steady_ms, 3)), **extra}),
          flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def demo_frame(gpt, seed=None):
    kw = {} if seed is None else {"seed": seed}
    img, edge = gpt.construct_test_img(
        (500, 500), 200, 4, 0.05, "sinusoidal", 0.3, gaps=True, **kw)
    grad = np.asarray(gpt.comp_grad_img(img, gpt.kernel_builder(
        (11, 5), unit=False)), np.float64)
    return img, grad, edge, edge[[0, -1]][:, [1, 0]]


def _slices_equal(fn, ys_axis1, whole, k=4):
    """Whether ``fn`` over k column slices of its sample input gives the
    columns of ``whole`` bit for bit (what a k-way sample shard sees)."""
    S = ys_axis1[0].shape[1]
    parts = [np.asarray(fn(*[a[:, i * S // k:(i + 1) * S // k]
                             for a in ys_axis1])) for i in range(k)]
    return bool(np.array_equal(np.concatenate(parts, axis=-1), whole))


def phase_kernel(card_id):
    import jax
    import jax.numpy as jnp

    from gaussian_process_edge_trace_tpu.ops.fused_cost import (
        fused_curve_costs)
    from gaussian_process_edge_trace_tpu.ops.posterior_draw import (
        posterior_draw, posterior_draw_reference)
    from gaussian_process_edge_trace_tpu.trace import scoring

    rng = np.random.default_rng(0)
    # (E, M, S, r, n): the demo, 1000x1000 at S=10^4 and 10^5, and an odd
    # E (the kernel's Cartwright-tail path). r and n are the prior rank
    # and training capacity those configs trace with.
    for E, M, S, r, n in [(500, 500, 1000, 56, 104),
                          (1000, 1000, 10_000, 48, 208),
                          (1000, 1000, 100_000, 48, 208),
                          (999, 1000, 10_000, 48, 208)]:
        cols = jnp.asarray(rng.random((E, M)), jnp.float32)
        x = np.linspace(0.0, 3.0, E)[:, None]
        ys = M / 2 + M / 4 * np.sin(x) + rng.normal(0, M / 20, (E, S))
        ys[:, :8] = rng.uniform(-5, M + 5, (E, 8))   # leave the image
        ys = jnp.asarray(ys, jnp.float32)
        kern = jax.jit(lambda c, y: fused_curve_costs(c, y, kde_thresh=1e-3))
        got, first, ms = timed(lambda: jax.block_until_ready(kern(cols, ys)))
        with jax.default_matmul_precision("highest"):
            want = jax.jit(lambda c, y: scoring.plain_curve_costs(
                c, jnp.arange(E, dtype=jnp.int32), y, kde_thresh=1e-3))(
                    cols, ys)
        got, want = np.asarray(got), np.asarray(want)
        rel = float(np.max(np.abs(got / want - 1.0)))
        # Top-N_keep sets agree except where a cost ties the cut-off.
        K = S // 10
        cut = np.sort(want)[K - 1]
        diff = (set(np.argsort(got, kind="stable")[:K])
                ^ set(np.argsort(want, kind="stable")[:K]))
        off = [i for i in diff
               if abs(want[i] - cut) > 2 * COST_RTOL * abs(cut)]
        width_free = _slices_equal(lambda y: kern(cols, y), [ys], got)
        report("cost_kernel_parity", card_id, first, ms, E=E, M=M, S=S,
               max_rel_err=rel, rtol=COST_RTOL, topk_diff=len(diff),
               slices_bitwise=width_free,
               uses_kernel_in_trace=scoring.use_fused_cost(E))
        check(rel <= COST_RTOL, f"fused cost rel err {rel} > {COST_RTOL}")
        check(not off, f"top-{K} sets differ beyond ties: {sorted(off)[:5]}")
        check(width_free, f"cost kernel bits depend on the draw width, S={S}")

        # Draw kernel: operands at the scales of a sampling round (c in
        # pixels, P and Q posterior-spread sized, z and w standard normal).
        c = jnp.asarray(rng.normal(M / 2, M / 10, E), jnp.float32)
        P = jnp.asarray(rng.normal(0, 0.3, (E, r)), jnp.float32)
        Q = jnp.asarray(rng.normal(0, 0.1, (E, n)), jnp.float32)
        z = jnp.asarray(rng.normal(size=(r, S)), jnp.float32)
        w = jnp.asarray(rng.normal(size=(n, S)), jnp.float32)
        draw = jax.jit(posterior_draw)
        got, first, ms = timed(lambda: jax.block_until_ready(
            draw(c, P, z, Q, w)))
        with jax.default_matmul_precision("highest"):
            want = jax.jit(posterior_draw_reference)(c, P, z, Q, w)
        got, want = np.asarray(got), np.asarray(want)
        dev = float(np.max(np.abs(want - np.asarray(c)[:, None])))
        err = float(np.max(np.abs(got - want))) / dev
        width_free = _slices_equal(lambda zz, ww: draw(c, P, zz, Q, ww),
                                   [z, w], got)
        report("draw_kernel_parity", card_id, first, ms, E=E, S=S, r=r, n=n,
               max_err_over_spread=err, tol=DRAW_TOL,
               slices_bitwise=width_free)
        check(err <= DRAW_TOL, f"draw kernel error {err} > {DRAW_TOL}")
        check(width_free, f"draw kernel bits depend on the draw width, S={S}")


def phase_demo(card_id, gpt):
    _, grad, edge, init = demo_frame(gpt)
    dices, first_by_seed = [], {}
    for seed in (1, 2, 3):
        tracer = gpt.GP_Edge_Tracing(
            init=init, grad_img=grad, kernel_options=DEMO_KO, obs=np.array([]),
            return_std=True, seed=seed, **DEMO_KW)
        (pred, _), first, ms = timed(tracer)
        dice = float(gpt.trace_dicecoef(pred, edge))
        dices.append(dice)
        first_by_seed[seed] = first
        report("demo_GP_Edge_Tracing", card_id, first, ms, seed=seed,
               dice=round(dice, 4),
               mse=round(float(gpt.trace_MSE(pred, edge)), 3),
               n_iters=int(tracer.last_result.n_iters))
    med = float(np.median(dices))
    print(f"demo: median DICE {med:.4f} over seeds 1-3 {dices}", flush=True)
    check(med > 0.985, f"demo median DICE {med} <= 0.985")
    check(min(dices) > 0.97, f"demo seed DICE {dices} has one <= 0.97")


def phase_batch(card_id, gpt):
    import jax

    from gaussian_process_edge_trace_tpu.parallel import (
        make_batch_data, make_batch_state, trace_batch_vmap)
    from gaussian_process_edge_trace_tpu.trace.driver import make_config

    B = 16
    frames = [demo_frame(gpt, seed=1 + f) for f in range(B)]
    cfg = make_config(frames[0][3], (500, 500), kernel_options=DEMO_KO,
                      seed=1, **DEMO_KW)
    data = make_batch_data(cfg, np.stack([f[1] for f in frames]),
                           np.stack([f[3] for f in frames]))
    states = make_batch_state(cfg, B)
    res, first, ms = timed(lambda: jax.block_until_ready(
        trace_batch_vmap(cfg, data, states)))
    traces = np.asarray(res.edge_trace)
    dices = [float(gpt.trace_dicecoef(traces[f], frames[f][2]))
             for f in range(B)]
    med = float(np.median(dices))
    report("batch16_trace_batch_vmap", card_id, first, ms,
           ms_per_trace=round(ms / B, 3), dice_median=round(med, 4),
           n_iters=np.asarray(res.n_iters).tolist(),
           converged=int(np.sum(np.asarray(res.converged))))
    check(bool(np.all(np.asarray(res.converged))),
          f"batch frames not converged: {np.asarray(res.converged)}")
    check(med > 0.96, f"batch median DICE {med} <= 0.96")


def big_frame(gpt):
    img, edge = gpt.construct_test_img(
        (1000, 1000), 400, 4, 0.05, "sinusoidal", 0.3, gaps=True)
    grad = np.asarray(gpt.comp_grad_img(img, gpt.kernel_builder(
        (11, 5), unit=False)), np.float64)
    return grad, edge, edge[[0, -1]][:, [1, 0]]


def phase_big(card_id, gpt):
    import jax
    import jax.numpy as jnp

    from gaussian_process_edge_trace_tpu.trace.driver import (
        init_state, make_config, make_data, run_trace)

    grad, edge, init = big_frame(gpt)
    for S in (10_000, 100_000):
        cfg = make_config(init, grad.shape, kernel_options=BIG_KO, seed=1,
                          **{**DEMO_KW, "N_samples": S})
        data = make_data(cfg, jnp.asarray(grad), jnp.asarray(init))
        state0 = init_state(cfg)
        res, first, ms = timed(lambda: jax.block_until_ready(
            run_trace(cfg, data, state0)))
        pred = np.asarray(res.edge_trace)
        dice = float(gpt.trace_dicecoef(pred, edge))
        report(f"run_trace_1000_S{S}", card_id, first, ms,
               dice=round(dice, 4),
               mse=round(float(gpt.trace_MSE(pred, edge)), 3),
               n_iters=int(res.n_iters), converged=bool(res.converged))
        check(bool(np.all(np.isfinite(np.asarray(res.y_mean)))),
              f"S={S}: non-finite posterior mean")
        if S == 10_000:
            check(dice > 0.97, f"1000x1000 S=1e4 DICE {dice} <= 0.97")


def phase_cli(card_id, gpt):
    from gaussian_process_edge_trace_tpu.__main__ import main as cli_main

    img, _, edge, init = demo_frame(gpt)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "demo.npy")
        out = os.path.join(tmp, "demo_trace.npz")
        np.save(src, np.asarray(img))
        t0 = time.perf_counter()
        cli_main(["trace", src, "--init", f"{init[0, 0]},{init[0, 1]}",
                  f"{init[1, 0]},{init[1, 1]}", "--sigma-f", "75",
                  "--length-scale", "20", "--n-samples", "1000",
                  "--delta-x", "5", "--seed", "1", "--out", out])
        wall = time.perf_counter() - t0
        check(os.path.exists(out), f"CLI wrote no {out}")
        z = np.load(out)
        trace = z["edge_trace"]
        check(trace.shape == (500, 2) and np.all(np.isfinite(trace)),
              f"CLI trace malformed: {trace.shape}")
        dice = float(gpt.trace_dicecoef(trace, edge))
    report("cli_trace_npy", card_id, wall, None,
           dice=round(dice, 4), n_iters=int(z["n_iters"]))


def phase_sharded(card_id, gpt):
    """Sharded == one card: ``sharded_trace_batch`` on each mesh against
    ``trace_batch_vmap`` over the whole batch on one card. Iteration
    counts, accepted pixels and the integer trace must be equal."""
    import jax
    import jax.numpy as jnp

    from gaussian_process_edge_trace_tpu.parallel import (
        make_batch_data, make_batch_state, make_mesh, sharded_trace_batch,
        trace_batch_vmap)
    from gaussian_process_edge_trace_tpu.trace.driver import make_config

    devs = jax.devices()
    check(len(devs) >= 4, f"--devices 4 needs 4 GPUs, found {len(devs)}")
    frames = [demo_frame(gpt, seed=1 + f) for f in range(4)]
    demo_cfg = make_config(frames[0][3], (500, 500), kernel_options=DEMO_KO,
                           seed=1, **DEMO_KW)
    demo_data = (np.stack([f[1] for f in frames]),
                 np.stack([f[3] for f in frames]))
    grad, _, init = big_frame(gpt)
    big_cfg = make_config(init, grad.shape, kernel_options=BIG_KO, seed=1,
                          **{**DEMO_KW, "N_samples": 10_000})
    big_data = (grad[None], np.asarray(init)[None])
    # A single frame cannot split over a data axis, so the 1000x1000 frame
    # runs on the sample-sharded (1, 4) mesh only.
    cases = [("demo_B4_S1000", demo_cfg, demo_data, [(1, 4), (2, 2), (4, 1)]),
             ("1000_B1_S10000", big_cfg, big_data, [(1, 4)])]
    fields = ("edge_trace", "n_iters", "converged", "obs_x", "obs_y",
              "obs_valid", "iter_nobs")
    failed = []
    for name, cfg, (grads, inits), meshes in cases:
        B = grads.shape[0]
        with jax.default_device(devs[0]):
            d1 = make_batch_data(cfg, grads, inits)
            s1 = make_batch_state(cfg, B)
            ref, first, ms = timed(lambda: jax.block_until_ready(
                trace_batch_vmap(cfg, d1, s1)))
            ref = jax.device_get(ref)
        report(f"sharded_ref_{name}_1card", card_id, first, ms,
               n_iters=np.asarray(ref.n_iters).tolist())
        for n_data, n_sample in meshes:
            mesh = make_mesh(n_data, n_sample, devices=devs[:4])
            data = make_batch_data(cfg, jnp.asarray(grads),
                                   jnp.asarray(inits))
            states = make_batch_state(cfg, B)
            res, first, ms = timed(lambda: jax.block_until_ready(
                sharded_trace_batch(cfg, data, states, mesh, n_frames=B)))
            res = jax.device_get(res)
            same = {f: bool(np.array_equal(np.asarray(getattr(ref, f)),
                                           np.asarray(getattr(res, f))))
                    for f in fields}
            report(f"sharded_{name}_mesh{n_data}x{n_sample}", card_id, first,
                   ms, n_iters=np.asarray(res.n_iters).tolist(),
                   matches_one_card=same)
            if not all(same.values()):
                failed.append(f"{name} mesh ({n_data},{n_sample}): {same}")
    check(not failed, f"sharded runs differ from one card: {failed}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded four-GPU phase")
    args = ap.parse_args(argv)

    # Phase 1: the device. No accelerator, no run.
    import jax
    devs = jax.devices()
    print("devices:", devs, [d.device_kind for d in devs], flush=True)
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found "
              f"{devs[0].platform!r}", file=sys.stderr)
        return 2
    card_id = card().splitlines()[0]
    print("card:", card_id, flush=True)

    sys.path.insert(0, ROOT)
    import gaussian_process_edge_trace_tpu as gpt

    if args.devices == 4:
        phase_sharded(card_id, gpt)
    else:
        phase_kernel(card_id)
        phase_demo(card_id, gpt)
        phase_batch(card_id, gpt)
        phase_big(card_id, gpt)
        phase_cli(card_id, gpt)
    print(card_id, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
