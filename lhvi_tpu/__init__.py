"""lhvi_tpu — lifted hybrid variational inference on JAX accelerators.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
``leodd/Lifted-Hybrid-Variational-Inference`` (hybrid discrete+continuous
factor graphs, relational/MLN grounding, lifted symmetry compression via
color passing, and a family of inference engines), re-designed for
batched accelerator execution:

- factor graphs compile to bucketed, statically-shaped array IR
  (``lhvi_tpu.fg``) evaluated as batched XLA/Pallas kernels;
- inference engines (``lhvi_tpu.engines``): NUTS/HMC-within-Gibbs,
  mixture-of-Gaussian VI with Gauss–Hermite quadrature ELBO, SMC with a
  collective resampler, GaBP, hybrid loopy BP, particle BP, MAP search;
- chains/particles shard over a ``jax.sharding.Mesh`` (``lhvi_tpu.parallel``).

Capability map and provenance: see SURVEY.md (the reference mount was empty
at survey time; the blueprint is SURVEY.md + BASELINE.json).
"""

__version__ = "0.1.0"

from lhvi_tpu.fg.graph import Domain, RV, F, Graph
from lhvi_tpu.fg.compile import compile_graph, CompiledFG
from lhvi_tpu.lift.color import compile_lifted

__all__ = [
    "Domain",
    "RV",
    "F",
    "Graph",
    "compile_graph",
    "compile_lifted",
    "CompiledFG",
    "__version__",
]
