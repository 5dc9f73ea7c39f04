"""Posterior-draw kernel for NVIDIA GPUs (Pallas through Triton).

A sampling round (models/gpr.py::fit_and_sample) draws S posterior curves
over E grid columns as one affine map of standard normal draws,

    samples = c[:, None] + (P @ z + Q @ w),

with c (E,), P (E, r) and Q (E, n) fixed for the round and z (r, S),
w (n, S) the draws. XLA picks its matrix-multiply kernel by shape, so
under XLA the bits of one sample's curve depend on S. A trace whose draws
are split over cards (parallel/sharded.py) would then score other curves
than one card drawing all S, and its trajectory would part from the
one-card trace at the first near-tie.

This kernel fixes the order of every sum. One program computes a
(BLOCK_E, BLOCK_S) tile of the output and walks the contraction in steps
of BLOCK_K, first over (P, z), then over (Q, w), then adds c. The blocks
are constants, so a sample's curve depends only on its own columns of z
and w: the same bits whatever S is and wherever the sample falls.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_E = 64
BLOCK_S = 64
BLOCK_K = 32

# The contraction runs in TF32 on the tensor cores, as XLA's default
# precision would run it. P and Q carry only the posterior's deviation
# from its mean (c), so TF32's 2^-11 relative rounding lands on the
# posterior spread, not on the pixel coordinate.
TF32 = True


def _kernel(c_ref, p_ref, z_ref, q_ref, w_ref, o_ref, *, E, S, R, N, tf32):
    e = pl.program_id(0) * BLOCK_E + jnp.arange(BLOCK_E, dtype=jnp.int32)
    s = pl.program_id(1) * BLOCK_S + jnp.arange(BLOCK_S, dtype=jnp.int32)
    e_ok = e < E
    s_ok = s < S
    kk = jnp.arange(BLOCK_K, dtype=jnp.int32)

    def contract(a_ref, b_ref, K, acc):
        def body(i, acc):
            k = i * BLOCK_K + kk
            k_ok = k < K
            a = plgpu.load(a_ref.at[e[:, None] * K + k[None, :]],
                           mask=e_ok[:, None] & k_ok[None, :], other=0.0)
            b = plgpu.load(b_ref.at[k[:, None] * S + s[None, :]],
                           mask=k_ok[:, None] & s_ok[None, :], other=0.0)
            return acc + pl.dot(a, b, allow_tf32=tf32)
        return jax.lax.fori_loop(0, -(-K // BLOCK_K), body, acc)

    acc = jnp.zeros((BLOCK_E, BLOCK_S), jnp.float32)
    acc = contract(p_ref, z_ref, R, acc)
    acc = contract(q_ref, w_ref, N, acc)
    c = plgpu.load(c_ref.at[e], mask=e_ok, other=0.0)
    plgpu.store(o_ref.at[e[:, None] * S + s[None, :]], c[:, None] + acc,
                mask=e_ok[:, None] & s_ok[None, :])


@functools.partial(jax.jit, static_argnames=("interpret",))
def posterior_draw(c, P, z, Q, w, interpret: bool = False):
    """(E, S) float32 ``c[:, None] + (P @ z + Q @ w)``, contracted in TF32
    if ``TF32`` is set when the call is traced.

    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on
    the CPU); on the GPU it compiles through Triton.
    """
    E, R = P.shape
    N = Q.shape[1]
    S = z.shape[1]
    if (c.shape != (E,) or z.shape[0] != R or Q.shape[0] != E
            or w.shape != (N, S)):
        raise ValueError(f"shapes do not chain: c {c.shape}, P {P.shape}, "
                         f"z {z.shape}, Q {Q.shape}, w {w.shape}")
    if max(E, R, N) * S >= 2 ** 31:
        raise ValueError("flat int32 indexing needs max(E, r, n) * S < 2**31")
    f32 = jnp.float32
    kernel = functools.partial(_kernel, E=E, S=S, R=R, N=N, tf32=TF32)
    # Under shard_map the output varies over the mesh axes the inputs do.
    vma = frozenset().union(*(jax.typeof(a).vma for a in (c, P, z, Q, w)))
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((E * S,), f32, vma=vma),
        grid=(pl.cdiv(E, BLOCK_E), pl.cdiv(S, BLOCK_S)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="posterior_draw",
    )(c.astype(f32), P.astype(f32).reshape(-1), z.astype(f32).reshape(-1),
      Q.astype(f32).reshape(-1), w.astype(f32).reshape(-1))
    return out.reshape(E, S)


def posterior_draw_reference(c, P, z, Q, w):
    """The same map in plain ``jnp`` (XLA picks the matmul kernels)."""
    return c[:, None] + (P @ z + Q @ w)
