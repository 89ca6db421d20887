"""Randomized lifting fuzz: the core invariant on generated models.

``k`` disjoint copies of a random hybrid base graph (shared Potential
objects, identical evidence) are exactly exchangeable, so color
refinement must compress them and the lifted ELBO with orbit-tied
parameters must equal the grounded ELBO with those parameters broadcast
to every copy — the invariant behind lifted VI (and the area of round
1's worst bug: quadratic fusion on same-orbit tied slots; copies whose
base graph has internal symmetry put both
slots of a pairwise factor on one orbit slot and exercise exactly that
path)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lhvi_tpu import RV, F, Graph, compile_graph
from lhvi_tpu.lift import compile_lifted
from lhvi_tpu.engines import vi

from test_fuzz_compile import _rand_graph


def _k_copies(g: Graph, k: int) -> Graph:
    rvs, factors = [], []
    for c in range(k):
        m = {}
        for rv in g.rvs:
            r2 = RV(rv.domain, name=f"{rv.name}_c{c}")
            r2.value = rv.value
            m[id(rv)] = r2
            rvs.append(r2)
        for f in g.factors:
            factors.append(F(f.potential, [m[id(rv)] for rv in f.nb]))
    return Graph(rvs, factors)


@pytest.mark.parametrize("seed", range(8))
def test_lifted_elbo_equals_grounded_on_copied_graphs(seed):
    rng = np.random.default_rng(2000 + seed)
    base = _rand_graph(rng)
    k = int(rng.integers(2, 5))
    g = _k_copies(base, k)

    fg_g = compile_graph(g)
    fg_l = compile_lifted(g)
    n_lat_g = fg_g.n_cont + fg_g.n_disc
    n_lat_l = fg_l.n_cont + fg_l.n_disc
    assert n_lat_g == k * (n_lat_l if k == 1 else n_lat_g // k)
    # k exchangeable copies MUST compress at least k-fold
    if n_lat_g:
        assert n_lat_l * k <= n_lat_g

    key = jax.random.PRNGKey(seed)
    cfg = vi.VIConfig(K=3)
    p_l = vi.init_params(fg_l, key, cfg)

    gather_c = np.zeros(fg_g.n_cont, np.int64)
    gather_d = np.zeros(fg_g.n_disc, np.int64)
    for rv in g.rvs:
        if rv.value is not None:
            continue
        kind_g, i_g = fg_g.meta.loc(rv)
        kind_l, i_l = fg_l.meta.loc(rv)
        assert kind_g == kind_l
        (gather_c if kind_g == "c" else gather_d)[i_g] = i_l
    p_g = vi.VIParams(
        log_w=p_l.log_w,
        mu=p_l.mu[:, gather_c] if fg_g.n_cont
        else jnp.zeros((cfg.K, 0)),
        log_sigma=p_l.log_sigma[:, gather_c] if fg_g.n_cont
        else jnp.zeros((cfg.K, 0)),
        logits=p_l.logits[:, gather_d] if fg_g.n_disc
        else jnp.zeros((cfg.K, 0, fg_g.max_v)),
    )
    e_l = float(vi.elbo(fg_l, p_l, n_quad=7))
    e_g = float(vi.elbo(fg_g, p_g, n_quad=7))
    np.testing.assert_allclose(e_l, e_g, rtol=1e-4, atol=2e-3)
