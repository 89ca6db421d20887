"""Device-mesh plumbing: sharded chains/particles and factor-axis TP.

SURVEY.md §3.2 build-side plan: data parallelism = chains/particles over a
``dp`` mesh axis (the primary axis); tensor parallelism = the factor/bucket
axis of the compiled graph over ``tp`` for pod-scale grounded models; ELBO
and log-prob reductions become ``psum``-style collectives inserted by XLA
from sharding annotations. Multi-host: ``jax.distributed.initialize`` then
the same code — the mesh simply spans hosts (DCN axis outermost).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lhvi_tpu.fg.compile import CompiledFG, FactorBucket


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("dp", "tp"),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    Default: all devices on the ``dp`` (chains/particles) axis, ``tp`` = 1.
    """
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, tuple(axis_names))


def chain_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Sharding for a leading chains/particles axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_chain_state(mesh: Mesh, xc, xd, axis: str = "dp"):
    """Place [C, …] chain state with the chain axis sharded."""
    sh = chain_sharding(mesh, axis)
    return jax.device_put(xc, sh), jax.device_put(xd, sh)


def chain_axes(shard: NamedSharding):
    """The mesh axis name(s) a chain-axis ``NamedSharding`` partitions
    over, as a tuple ('' sharding → ())."""
    if shard is None or not len(shard.spec):
        return ()
    ax = shard.spec[0]
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def n_chain_shards(shard: NamedSharding) -> int:
    """How many ways a chain-axis sharding partitions its leading axis
    (1 for None/replicated). THE divisibility authority: every site that
    asks "does this chain count split evenly over the mesh?" must use
    this so kernel-eligibility checks and the shard_map fallback agree."""
    axes = chain_axes(shard)
    if not axes:
        return 1
    return int(np.prod([shard.mesh.shape[a] for a in axes]))


def shard_map_chains(fn, shard: NamedSharding, n_sharded_args: int,
                     fallback=None):
    """Wrap ``fn`` in ``shard_map`` over the chain axis of ``shard``.

    The first ``n_sharded_args`` positional args are partitioned on their
    leading (chains) axis; the rest are replicated. Every output is
    chain-leading and partitioned the same way. This is how the Triton
    quad leapfrog composes with a sharded chain axis: a bare ``pallas_call``
    does not SPMD-partition, but per-shard invocation under ``shard_map``
    runs one kernel instance per device with no cross-device traffic
    (the kernels are embarrassingly parallel over chains).

    ``fallback`` (default ``fn``) handles chain counts not divisible by
    the mesh axis size — it runs OUTSIDE shard_map, so it must not use
    ``axis_index``.
    """
    axes = chain_axes(shard)
    if not axes:
        return fallback if fallback is not None else fn
    spec = P(axes if len(axes) > 1 else axes[0])
    n_shards = n_chain_shards(shard)

    def wrapper(*args):
        if args[0].shape[0] % n_shards != 0:
            # shard_map needs the chain axis divisible by the mesh axis;
            # uneven counts fall back to the direct call (GSPMD keeps it
            # correct, at gather cost — pad n_chains to a multiple of the
            # device count to stay on the per-shard path)
            import warnings

            warnings.warn(
                f"chain axis {args[0].shape[0]} not divisible by the "
                f"{n_shards}-way mesh axis {axes}: falling back to an "
                "unpartitioned kernel call, which gathers the full chain "
                "state onto one device every transition. Pad n_chains to "
                "a multiple of the device count to stay on the per-shard "
                "path.", stacklevel=2,
            )
            return (fallback if fallback is not None else fn)(*args)
        in_specs = tuple(
            spec if i < n_sharded_args else P() for i in range(len(args))
        )
        return jax.shard_map(
            fn, mesh=shard.mesh, in_specs=in_specs, out_specs=spec,
            check_vma=False,
        )(*args)

    return wrapper


def shard_fg_factors(fg: CompiledFG, mesh: Mesh, axis: str = "tp") -> CompiledFG:
    """Tensor-parallel placement: shard every bucket's factor axis.

    Requires bucket sizes divisible by the axis size — ``compile_graph``'s
    ``pad_to`` should be a multiple of it. Per-variable tables stay
    replicated; XLA turns the bucket reductions into psums over ``tp``.
    """
    size = mesh.shape[axis]
    fsh = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def place_bucket(b: FactorBucket) -> FactorBucket:
        if b.n_factors % size != 0:
            raise ValueError(
                f"bucket {b.kind} has {b.n_factors} rows, not divisible by "
                f"tp={size}; compile with pad_to a multiple of it"
            )

        def shard_leaf(x):
            spec = P(axis) if x.ndim >= 1 else P()
            return jax.device_put(x, NamedSharding(mesh, spec))

        return b.replace(
            params=jax.tree_util.tree_map(shard_leaf, b.params),
            cont_idx=jax.device_put(b.cont_idx, fsh),
            cont_mask=jax.device_put(b.cont_mask, fsh),
            cont_const=jax.device_put(b.cont_const, fsh),
            disc_idx=jax.device_put(b.disc_idx, fsh),
            disc_mask=jax.device_put(b.disc_mask, fsh),
            disc_first=jax.device_put(b.disc_first, fsh),
            disc_const=jax.device_put(b.disc_const, fsh),
            disc_vals=jax.device_put(b.disc_vals, fsh),
            disc_size=jax.device_put(b.disc_size, fsh),
            scale=jax.device_put(b.scale, fsh),
        )

    return fg.replace(
        buckets=tuple(place_bucket(b) for b in fg.buckets),
        disc_sizes=jax.device_put(fg.disc_sizes, rep),
        disc_vals=jax.device_put(fg.disc_vals, rep),
        color_of=jax.device_put(fg.color_of, rep),
        cont_lo=jax.device_put(fg.cont_lo, rep),
        cont_hi=jax.device_put(fg.cont_hi, rep),
        cont_ipoints=jax.device_put(fg.cont_ipoints, rep),
        cont_counts=jax.device_put(fg.cont_counts, rep),
        disc_counts=jax.device_put(fg.disc_counts, rep),
    )
