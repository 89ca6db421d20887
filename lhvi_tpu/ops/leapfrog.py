"""Fused leapfrog for quadratic (information-form) targets.

When a model's continuous part is fully fused into ``(J, h)``
(``CompiledFG.quad``), the leapfrog gradient is ``h − xJ``. XLA runs each
of the n_steps as a separate ``[C,n]×[n,n]`` product plus an elementwise
fusion, so positions and momenta go through device memory about
2·(n_steps+1) times per proposal. The Triton kernel here runs the whole
n-step integration for a block of chains in one program: x and p stay in
registers, J stays on chip, and the state is written once.

Numerics: the endpoint feeds an MH ratio, so every product is f32-grade.
The XLA body pins ``Precision.HIGHEST`` (IEEE f32). The kernel uses the
three-pass TF32 algorithm (``DotAlgorithmPreset.TF32_TF32_F32_X3``: each
operand split into a TF32 head and tail, three tensor-core products
summed in f32), whose error against a float64 leapfrog matched IEEE f32
on an H100 while a plain IEEE f32 ``tl.dot``, which cannot use the
tensor cores, lost to XLA. Given the same X3 algorithm, the XLA body is
slower than at HIGHEST, so the kernel's lead is fusion, not precision
(PERF.md). The CPU has no TF32, so interpret mode runs the kernel's dot
in IEEE f32. The merged half-kick formulation
composes to exactly the same map as the naive two-half-kicks-per-step
integrator, so acceptance statistics are unchanged.

Kernel choice (``use_triton``) is made here and nowhere else: the Triton
kernel on the GPU when the padded J fits on chip (``n ≤ TRITON_MAX_N``),
the XLA body otherwise (larger dense J, CPU). Sparse targets use the ELL
path below (``ell_quad_leapfrog``) or ``ops.dia``; non-quadratic models
use the autodiff leapfrog in ``ops.logpot``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

# Largest latent count the kernel keeps J on chip for: f32 J padded to
# 128² is 64 KB of the 227 KB of shared memory a Hopper block may use;
# 256² (256 KB) does not fit, so wider dense targets take the XLA body.
TRITON_MAX_N = 128
# chains per program and warps per program (power-of-two block; tuned on
# an H100 at the headline shape, see PERF.md)
BLOCK_CHAINS = 128
NUM_WARPS = 8
# the kernel's dot algorithm on the card (see module docstring)
_KERNEL_DOT = jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3


def _jnp_quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps: int,
                       precision=_HI):
    """Reference and XLA path (batched, merged half-kicks)."""

    def grad(x):
        return h - jnp.dot(x, J, precision=precision)

    p = p + 0.5 * eps * grad(x)

    def body(i, xp):
        x, p = xp
        x = x + eps * inv_mass * p
        g = grad(x)
        last = i == n_steps - 1
        p = p + jnp.where(last, 0.5, 1.0) * eps * g
        return (x, p)

    x, p = jax.lax.fori_loop(0, n_steps, body, (x, p))
    return x, p


def _pad_width(n: int) -> int:
    # Triton blocks are powers of two, and tl.dot wants every dim ≥ 16
    return max(16, 1 << max(n - 1, 0).bit_length())


def _leapfrog_kernel(x_ref, p_ref, J_ref, h_ref, im_ref, eps_ref,
                     xo_ref, po_ref, *, n_steps: int, block_chains: int,
                     n_pad: int, dot_precision):
    """One program integrates ``block_chains`` chains for all n_steps.

    Lanes past n (and rows past C) load as zeros; with J, h and inv_mass
    zero there, their gradient and drift are zero, so they stay inert and
    are masked off on the store."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    C, n = x_ref.shape
    rows = pl.program_id(0) * block_chains + jnp.arange(block_chains)
    cols = jnp.arange(n_pad)
    cmask = cols < n
    mask = (rows < C)[:, None] & cmask[None, :]
    blk = (rows[:, None], cols[None, :])
    x = plgpu.load(x_ref.at[blk], mask=mask, other=0.0)
    p = plgpu.load(p_ref.at[blk], mask=mask, other=0.0)
    J = plgpu.load(J_ref.at[cols[:, None], cols[None, :]],
                   mask=cmask[:, None] & cmask[None, :], other=0.0)
    h = plgpu.load(h_ref.at[cols], mask=cmask, other=0.0)[None, :]
    im = plgpu.load(im_ref.at[cols], mask=cmask, other=0.0)[None, :]
    eps = eps_ref[0]

    def grad(x):
        return h - jnp.dot(x, J, precision=dot_precision,
                           preferred_element_type=jnp.float32)

    p = p + 0.5 * eps * grad(x)

    def body(_, xp):
        x, p = xp
        x = x + eps * im * p
        return x, p + eps * grad(x)

    # the same map as the XLA body's select on the last step, which the
    # Triton lowering does not take inside a loop
    x, p = jax.lax.fori_loop(0, n_steps - 1, body, (x, p))
    x = x + eps * im * p
    p = p + 0.5 * eps * grad(x)
    plgpu.store(xo_ref.at[blk], x, mask=mask)
    plgpu.store(po_ref.at[blk], p, mask=mask)


@functools.partial(jax.jit, static_argnames=(
    "n_steps", "block_chains", "interpret"))
def _triton_quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps: int,
                          block_chains: int = BLOCK_CHAINS,
                          interpret: bool = False):
    """Pallas kernel lowered through Triton; ``interpret=True`` runs it on
    the CPU (tests only, which also pick small blocks)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    C, n = x.shape
    kernel = functools.partial(_leapfrog_kernel, n_steps=n_steps,
                               block_chains=block_chains,
                               n_pad=_pad_width(n),
                               dot_precision=_HI if interpret else _KERNEL_DOT)
    out = jax.ShapeDtypeStruct((C, n), jnp.float32)
    return pl.pallas_call(
        kernel,
        out_shape=(out, out),
        grid=(pl.cdiv(C, block_chains),),
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="quad_leapfrog",
    )(x, p, J, h, inv_mass, jnp.reshape(jnp.asarray(eps, jnp.float32), (1,)))


def use_triton(n: int, backend: str = None) -> bool:
    """The one place the dense leapfrog picks its implementation: the
    Triton kernel on a GPU when the padded J fits on chip, XLA otherwise."""
    backend = jax.default_backend() if backend is None else backend
    return backend == "gpu" and n <= TRITON_MAX_N


def quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps: int, shard=None):
    """Batched leapfrog on the fused quadratic target.

    x, p: [C, n]; J: [n, n]; h, inv_mass: [n]; eps: scalar (traced ok).
    ``shard`` (chain-axis NamedSharding) runs one kernel instance per
    device via ``shard_map`` — a bare ``pallas_call`` does not
    SPMD-partition; the integrator is chain-parallel so shards never
    communicate and the result is bitwise-identical to the unsharded
    kernel. The XLA body partitions under GSPMD as it is.
    """
    if n_steps < 1 or not use_triton(x.shape[1]):
        return _jnp_quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps)
    if shard is not None:
        from lhvi_tpu.parallel.mesh import shard_map_chains

        fn = shard_map_chains(
            lambda x_, p_, J_, h_, im_, eps_: _triton_quad_leapfrog(
                x_, p_, J_, h_, im_, eps_, n_steps),
            shard, n_sharded_args=2,
        )
        return fn(x, p, J, h, inv_mass, eps)
    return _triton_quad_leapfrog(x, p, J, h, inv_mass, eps, n_steps)


def ell_matvec(x, diag, col, w):
    """``J @ x`` for a batch in ELL form: x [C, n] → [C, n].

    THE single codegen point for the sparse matvec (HMC leapfrog here;
    NUTS gradients / VI / log-prob via ``CompiledFG.quad_matvec_batched``,
    which delegates). For small static D the neighbor sum unrolls into D
    gather·FMA ops that XLA fuses into the accumulation — the one-shot
    ``sum(w * x[:, col], -1)`` materializes [C, n, D] in device memory.
    """
    y = x * diag[None]
    D = col.shape[1]
    if D <= 16:
        for d in range(D):
            y = y + w[None, :, d] * x[:, col[:, d]]
        return y
    return y + jnp.sum(w[None] * x[:, col], axis=-1)


def ell_quad_leapfrog(x, p, diag, col, w, h, inv_mass, eps, n_steps: int):
    """Batched leapfrog on a SPARSE (ELL) quadratic target.

    x, p: [C, n]; diag, h, inv_mass: [n]; col/w: [n, D] padded-neighbor
    tables (see ``CompiledFG.quad_matvec_batched``); eps traced ok.
    Returns ``(x1, p1, g0, g1)`` — the endpoint gradients are free here
    and let the caller form both Hamiltonians without extra matvecs
    (lp = c + ½·x·(h + g)).

    ∇log p = h − J x via ``ell_matvec`` (see its docstring for the
    unrolled gather·FMA codegen rationale). Written position-Verlet so
    the loop body has ONE kick: n_steps costs n_steps+1 matvecs, and the
    momentum round-trips HBM once per step instead of twice. Pure XLA
    (GSPMD partitions it natively on a sharded chain axis).
    """

    def matvec(x):
        return ell_matvec(x, diag, col, w)

    g0 = h[None] - matvec(x)
    if n_steps == 0:
        # degenerate no-op config: the position-Verlet tail below would
        # otherwise still apply one drift + final half-kick
        return x, p, g0, g0
    m = p + 0.5 * eps * g0

    def body(_, carry):
        x, m = carry
        x = x + eps * inv_mass[None] * m
        g = h[None] - matvec(x)
        m = m + eps * g
        return x, m

    x, m = jax.lax.fori_loop(0, n_steps - 1, body, (x, m))
    x = x + eps * inv_mass[None] * m
    g1 = h[None] - matvec(x)
    p1 = m + 0.5 * eps * g1
    return x, p1, g0, g1
