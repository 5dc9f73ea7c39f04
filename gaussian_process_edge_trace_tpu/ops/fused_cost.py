"""Fused curve-cost kernel for NVIDIA GPUs (Pallas through Triton).

The curve cost (trace/scoring.py::curve_costs) of S posterior curves over
E grid columns is two Simpson quadratures over quantities derived from the
(E, S) samples: the gradient score interpolated at every curve point, and
the Euclidean step between neighbouring points. Written in plain
``jnp``, XLA materialises the (E, S) gradient scores and steps in device
memory and reads them back for the reductions; at 1000 columns and 10⁵
samples each such array is 400 MB.

This kernel reads the samples once and writes only per-chunk partial
sums of the two quadratures. The grid is (sample blocks × row chunks): one
program owns a power-of-two block of samples and a chunk of ``pairs``
Simpson interval pairs (2·pairs rows), and walks its rows inside the
program, two rows per loop step, carrying the partial line integral and
arc length and the previous rows' values in registers. Splitting the rows
over programs shortens the sequential loop each program runs, which at
the trace's shapes is what bounds the kernel's time. Each point's
gradient score is a direct two-tap gather from its column of the (E, M)
gradient table, which is a few MB and stays in L2. The wrapper adds the
(chunks, S) partials and divides.

Arithmetic is the plain path's, term for term: the same clamped linear
interpolation (``ops/interp.py::column_interp``), the same non-uniform
pair rule (``ops/integrate.py::_pair_contributions``) and the uniform
Simpson weights 1/3, 4/3, 1/3 per pair for the arc length. Only the order
of the sums differs, so results agree with the plain path to f32
reassociation. Every sum runs in an order fixed by constants, so a
sample's cost is bitwise the same whatever S is.

For even E both quadratures have an odd point count (E − 1), the pair
rule covers them exactly, and the ``even="simpson"`` and ``even="avg"``
rules coincide. For odd E the kernel covers the leading odd block and the
wrapper adds the even-count rule's trailing terms, which are elementwise
in the samples: the Cartwright tail, or for ``even="avg"`` a second
kernel pass over the points from 1 on plus the two trapezoids.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gaussian_process_edge_trace_tpu.ops.integrate import _pair_contributions


def block_for(S: int) -> int:
    """Samples per program (a power of two): 64 from S=8192 on, which an
    H100 sweep found fastest at S=10⁴ and 10⁵; 32 below it."""
    return 64 if S >= 8192 else 32


# Simpson pairs per program (a row chunk is 2·PAIRS rows). It sets the
# order of the sums, so it is a constant: a sample's cost is then bitwise
# the same whatever S is, and a sample-sharded trace scores its shard
# exactly as one device scores the whole draw. 32 was the fastest of
# 8-64 at 1000x1000, S=10⁵ on an H100 (PERF.md).
PAIRS = 32


def _kernel(cols_ref, ys_ref, line_ref, arc_ref, *, E, M, S, block, pairs,
            kde_thresh):
    s_idx = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    live = s_idx < S
    chunk = pl.program_id(1)
    n_pairs = (E - 2) // 2
    third = np.float32(1.0 / 3.0)

    def row(e, ok=True):
        return plgpu.load(ys_ref.at[e * S + s_idx], mask=live & ok,
                          other=0.0)

    def grad(e, y):
        # ops/interp.py::column_interp, plus the kde_thresh floor. Indices
        # are clamped, so the gather needs no mask.
        yc = jnp.clip(y, 0.0, M - 1.0)
        r0 = jnp.clip(jnp.floor(yc), 0.0, M - 2.0).astype(jnp.int32)
        fr = yc - r0.astype(jnp.float32)
        base = jnp.minimum(e, E - 1) * M + r0
        v0 = plgpu.load(cols_ref.at[base])
        v1 = plgpu.load(cols_ref.at[base + 1])
        return v0 + fr * (v1 - v0) + kde_thresh

    def step(ya, yb):
        d = yb - ya
        return jnp.sqrt(1.0 + d * d)

    # Loop step k closes Simpson pair k: points 2k, 2k+1, 2k+2 of the line
    # integral (widths step[2k+1], step[2k+2]) and of the arc length
    # (values step[2k], step[2k+1], step[2k+2]). Carry: g[2k], y[2k+1],
    # step[2k], and the two partial sums. Steps past the last pair load
    # nothing and add nothing.
    k0 = chunk * pairs
    y0 = row(2 * k0)
    y1 = row(2 * k0 + 1)
    zero = jnp.zeros((block,), jnp.float32)

    def body(i, c):
        g_e, y_o, s_e, line, arc = c
        k = k0 + i
        ok = k < n_pairs
        e1 = 2 * k + 1
        y2 = row(e1 + 1, ok)
        y3 = row(e1 + 2, ok)
        g1 = grad(e1, y_o)
        g2 = grad(e1 + 1, y2)
        s1 = step(y_o, y2)
        s2 = step(y2, y3)
        line = line + jnp.where(
            ok, _pair_contributions(g_e, g1, g2, s1, s2), 0.0)
        arc = arc + jnp.where(ok, third * (s_e + 4.0 * s1 + s2), 0.0)
        return g2, y3, s2, line, arc

    _, _, _, line, arc = jax.lax.fori_loop(
        0, pairs, body, (grad(2 * k0, y0), y1, step(y0, y1), zero, zero))
    out = chunk * S + s_idx
    plgpu.store(line_ref.at[out], line, mask=live)
    plgpu.store(arc_ref.at[out], arc, mask=live)


@functools.partial(jax.jit, static_argnames=("kde_thresh", "even",
                                              "interpret"))
def fused_curve_costs(cols, ys, kde_thresh: float = 0.0,
                      even: str = "simpson", interpret: bool = False):
    """(S,) float32 curve costs of the (E, S) samples ``ys`` against the
    (E, M) gradient columns ``cols``; E >= 4. ``even`` is the
    even-point-count Simpson rule of trace/scoring.py::curve_costs.

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on
    the CPU); on the GPU it compiles through Triton.
    """
    E, M = cols.shape
    E2, S = ys.shape
    if E != E2 or E < 4 or M < 2:
        raise ValueError(f"need E >= 4 and M >= 2, got cols {cols.shape}"
                         f", samples {ys.shape}")
    if E * max(S, M) >= 2 ** 31:
        raise ValueError("flat int32 indexing needs E * max(S, M) < 2**31")
    cols = cols.astype(jnp.float32)
    ys = ys.astype(jnp.float32)
    line, arc = _pair_sums(cols, ys, float(kde_thresh), interpret)
    if E % 2 == 0:
        return arc / line

    def g(e):                       # gradient score at row e, as the kernel
        yc = jnp.clip(ys[e], 0.0, M - 1.0)
        r0 = jnp.clip(jnp.floor(yc), 0.0, M - 2.0).astype(jnp.int32)
        v0, v1 = cols[e][r0], cols[e][r0 + 1]
        return v0 + (yc - r0.astype(jnp.float32)) * (v1 - v0) + kde_thresh

    def st(j):                      # step between rows j and j + 1
        d = ys[j + 1] - ys[j]
        return jnp.sqrt(1.0 + d * d)

    # Line points are rows 0..E-2 with widths step[1..E-2]; arc points are
    # step[0..E-2] at unit spacing (ops/integrate.py, even point count).
    if even == "avg":
        line1, arc1 = _pair_sums(cols[1:], ys[1:], float(kde_thresh),
                                 interpret)
        first_l = line + 0.5 * (g(E - 2) + g(E - 3)) * st(E - 2)
        second_l = 0.5 * (g(0) + g(1)) * st(1) + line1
        first_a = arc + 0.5 * (st(E - 2) + st(E - 3))
        second_a = 0.5 * (st(0) + st(1)) + arc1
        return (0.5 * (first_a + second_a)) / (0.5 * (first_l + second_l))
    h0, h1 = st(E - 3), st(E - 2)
    alpha = (2 * h1 * h1 + 3 * h0 * h1) / (6 * (h0 + h1))
    beta = (h1 * h1 + 3 * h0 * h1) / (6 * h0)
    eta = h1 * h1 * h1 / (6 * h0 * (h0 + h1))
    line = line + (alpha * g(E - 2) + beta * g(E - 3) - eta * g(E - 4))
    arc = arc + (np.float32(5 / 12) * st(E - 2) + np.float32(2 / 3) * st(E - 3)
                 - np.float32(1 / 12) * st(E - 4))
    return arc / line


def _pair_sums(cols, ys, kde_thresh, interpret):
    """Kernel pass: the (line integral, arc length) pair-rule sums over the
    leading odd-count block of each quadrature, (S,) each."""
    E, M = cols.shape
    S = ys.shape[1]
    block = block_for(S)
    n_chunks = -(-((E - 2) // 2) // PAIRS)
    kernel = functools.partial(_kernel, E=E, M=M, S=S, block=block,
                               pairs=PAIRS, kde_thresh=float(kde_thresh))
    # Under shard_map the outputs vary over the mesh axes the inputs do.
    vma = jax.typeof(cols).vma | jax.typeof(ys).vma
    part = jax.ShapeDtypeStruct((n_chunks * S,), jnp.float32, vma=vma)
    line, arc = pl.pallas_call(
        kernel,
        out_shape=(part, part),
        grid=(pl.cdiv(S, block), n_chunks),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, min(4, block // 32)), num_stages=2),
        interpret=interpret,
        name="fused_curve_cost",
    )(cols.reshape(-1), ys.reshape(-1))
    # Chunk partials added in a fixed order (a reduce could be reordered by
    # shape, which would break the bitwise independence of S above).
    line = line.reshape(n_chunks, S)
    arc = arc.reshape(n_chunks, S)
    line_sum, arc_sum = line[0], arc[0]
    for c in range(1, n_chunks):
        line_sum = line_sum + line[c]
        arc_sum = arc_sum + arc[c]
    return line_sum, arc_sum
