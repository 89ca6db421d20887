"""Robot-mapping HMLN experiment family: hybrid
relational model + evidence-file workflow, validated against the exact
oracle on a small instance."""

import numpy as np
import jax

from lhvi_tpu import compile_graph
from lhvi_tpu.engines import hmc, vi
from lhvi_tpu.models.relational import robot_map, robot_scan_evidence
from lhvi_tpu.relational.data import load_evidence
from lhvi_tpu.utils.oracle import ExactPosterior


def small_instance():
    """5 segments; depths observed on all but s1/s3; one labeled type."""
    text, true_types = robot_scan_evidence(
        5, seed=2, depth_miss_every=2, n_type_labels=1
    )
    ev = load_evidence(text)
    rg = robot_map(5, evidence=ev)
    g, index = rg.ground()
    return g, index, true_types


def test_evidence_file_roundtrip():
    text, _ = robot_scan_evidence(8, seed=0)
    ev = load_evidence(text)
    assert ("type", ("s0",)) in ev
    assert any(k[0] == "depth" for k in ev)
    rg = robot_map(8, evidence=ev)
    g, index = rg.ground()
    n_obs = sum(1 for rv in g.rvs if rv.observed)
    assert n_obs == len(ev)


def test_robot_map_hmc_vs_exact():
    g, index, _ = small_instance()
    exact = ExactPosterior(g, cont_grid=81)
    fg = compile_graph(g)
    res = hmc.sample(
        fg, jax.random.PRNGKey(0),
        cfg=hmc.HMCConfig(n_leapfrog=8, init_step_size=0.2, gibbs_sweeps=2),
        n_chains=64, n_warmup=400, n_samples=1500, collect="moments",
    )
    for i in range(5):
        rv_t = index[("type", (f"s{i}",))]
        if not rv_t.observed:
            got = np.asarray(res.disc_marginal(rv_t))
            want = np.asarray(exact.disc_marginal(rv_t))
            assert np.abs(got - want).max() < 0.06, (i, got, want)
        rv_d = index[("depth", (f"s{i}",))]
        if not rv_d.observed:
            assert abs(res.mean(rv_d) - exact.mean(rv_d)) < 0.08, i
            assert abs(res.var(rv_d) - exact.var(rv_d)) < 0.1, i


def test_robot_map_vi_vs_exact():
    g, index, _ = small_instance()
    exact = ExactPosterior(g, cont_grid=81)
    fg = compile_graph(g)
    res = vi.infer(fg, jax.random.PRNGKey(1),
                   vi.VIConfig(K=4, n_iters=2500, lr=5e-2))
    for i in range(5):
        rv_t = index[("type", (f"s{i}",))]
        if not rv_t.observed:
            got = np.asarray(res.disc_marginal(rv_t))
            want = np.asarray(exact.disc_marginal(rv_t))
            assert np.abs(got - want).max() < 0.12, (i, got, want)
        rv_d = index[("depth", (f"s{i}",))]
        if not rv_d.observed:
            assert abs(res.mean(rv_d) - exact.mean(rv_d)) < 0.1, i


def test_fast_compile_matches_object_path():
    """The vectorized relational→IR compiler grounds the robot-map HMLN
    (adjacency templates, mixed continuous/discrete predicates, on-disk
    evidence) to the same distribution as the object path."""
    import numpy as np
    import jax.numpy as jnp
    from lhvi_tpu.relational.fast import fast_compile

    text, _ = robot_scan_evidence(24, seed=0)
    fgf = fast_compile(robot_map(24, evidence=load_evidence(text)))
    g, index = robot_map(24, evidence=load_evidence(text)).ground()
    fgo = compile_graph(g)
    assert (fgf.n_cont, fgf.n_disc) == (fgo.n_cont, fgo.n_disc)

    rng = np.random.default_rng(0)
    for _ in range(4):
        xc_f = rng.normal(0, 1, fgf.n_cont).astype(np.float32)
        xd_f = rng.integers(0, 3, fgf.n_disc).astype(np.int32)
        xc_o = np.zeros(fgo.n_cont, np.float32)
        xd_o = np.zeros(fgo.n_disc, np.int32)
        for key, rv in index.items():
            kind_o, i_o = fgo.meta.loc(rv)
            kind_f, i_f = fgf.meta.loc(key)
            assert kind_o == kind_f, key
            if kind_o == "c":
                xc_o[i_o] = xc_f[i_f]
            elif kind_o == "d":
                xd_o[i_o] = xd_f[i_f]
        lf = float(fgf.log_prob(jnp.asarray(xc_f), jnp.asarray(xd_f)))
        lo = float(fgo.log_prob(jnp.asarray(xc_o), jnp.asarray(xd_o)))
        assert abs(lf - lo) < 1e-2 * max(1.0, abs(lo)), (lf, lo)
