"""Potential base protocol + kernel conventions.

Parity target: the reference's ``Potential.py`` / ``MLNPotential.py``
per-class ``get(x)`` evaluators (SURVEY.md §3.1; mount empty — behavioral
reconstruction). Batched redesign: every potential *type* contributes one
batched, jit-traceable ``log φ`` kernel operating on stacked parameter
arrays for a whole bucket of same-type factors at once; the host-side
``Potential`` objects only *declare* parameters.

Kernel signature (one kernel per bucket)::

    log_pot(params, xc, xdi, xdv) -> f32[...]

- ``params``: dict of arrays; each leaf is broadcastable against the batch
  dims of ``xc`` (the compiler stacks per-factor params along axis 0 and
  inserts singleton axes to align with any extra batch axes, e.g. a
  quadrature-grid axis).
- ``xc``: f32 ``[..., ac]`` continuous argument slots (original factor
  argument order restricted to continuous slots).
- ``xdi``: i32 ``[..., ad]`` discrete argument slots as *indices* into each
  slot's domain (used by table lookups).
- ``xdv``: f32 ``[..., ad]`` the same discrete slots as domain *values*
  (used by formula/feature potentials).

``kernel(pattern)`` receives the bucket's continuity pattern — a tuple of
bools, one per original argument slot, True = continuous — so potentials
whose semantics depend on argument order across types (MLN formulas) can
reassemble the original tuple.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import numpy as np


class Potential:
    """Host-side potential declaration.

    Subclasses define:
      - ``bucket_key()``: hashable key; factors sharing a key (plus the same
        continuity/evidence pattern, added by the compiler) are batched into
        one bucket and evaluated by one kernel instance.
      - ``param_arrays()``: dict of numpy arrays (stacked along axis 0 by the
        compiler across the bucket).
      - ``kernel(pattern)``: the batched log-potential function.
      - ``symmetric``: True if invariant to argument permutation (consumed by
        the lifting color refinement).
    """

    symmetric: bool = False

    def bucket_key(self) -> Hashable:
        raise NotImplementedError

    def param_arrays(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def kernel(self, pattern: Tuple[bool, ...]) -> Callable:
        raise NotImplementedError

    def kernel_planar(self, pattern: Tuple[bool, ...]):
        """Optional factor-minor kernel: ``log_pot(params, slots)`` where
        ``slots`` is a list of SAME-SHAPED ``[..., F]`` arrays, one per
        argument in order (continuous values / discrete domain values),
        and every ``params`` leaf is 2D ``[k, F]`` — the per-factor
        component dims flattened row-major into ``k`` rows, factors on
        the minor axis. Components are read with static row slices
        (``leaf[i:i+1]`` → ``[1, F]``), which broadcast against slots.

        This is the layout a fused non-quadratic leapfrog kernel would
        consume (factors contiguous on the minor axis, components
        unrolled; ROADMAP queues such a kernel). No engine uses it today.
        Return None (default) to opt out.
        """
        return None

    def color_key(self) -> Hashable:
        """Identity used to seed factor colors in color refinement."""
        return (self.bucket_key(), _np_key(self.param_arrays()))

    def log_value(self, args, pattern: Tuple[bool, ...]):
        """Scalar convenience evaluation for tests.

        ``args``: full ordered argument tuple; continuous slots are floats,
        discrete slots are (index, value) pairs.
        """
        import jax.numpy as jnp

        xc = [a for a, c in zip(args, pattern) if c]
        xd = [a for a, c in zip(args, pattern) if not c]
        xdi = jnp.asarray([[i for i, _ in xd]], jnp.int32).reshape(1, -1)
        xdv = jnp.asarray([[v for _, v in xd]], jnp.float32).reshape(1, -1)
        xc = jnp.asarray(xc, jnp.float32).reshape(1, -1)
        params = {
            k: jnp.asarray(v)[None] for k, v in self.param_arrays().items()
        }
        return float(self.kernel(pattern)(params, xc, xdi, xdv)[0])


def _np_key(d: Dict[str, np.ndarray]) -> Hashable:
    return tuple((k, v.shape, v.tobytes()) for k, v in sorted(d.items()))
