"""Collapsed orbit-flip mode-swap move (engines/modeswap.py).

Exactness vs enumeration on an intra-coupled spin block whose single-site
flips are strongly suppressed, structural invariants of the plan (F
independence, direct-row masking), and the production failure it exists
to fix: the friends-smokers ferromagnetic smokes clique freezing every
chain at a chain-specific joint mode (discrete mode-locking; SURVEY.md
§5.2 comparison-against-exact methodology).
"""

import numpy as np
import jax

from lhvi_tpu import Domain, F, Graph, RV, compile_graph
from lhvi_tpu.engines import hmc
from lhvi_tpu.engines.modeswap import (
    build_mode_swap_plan,
    mode_swap_sweep,
)
from lhvi_tpu.potentials import MLNPotential, leq
from lhvi_tpu.utils.oracle import ExactPosterior


def spin_clique(n=4, w=2.5, bias=0.4):
    """n exchangeable binary spins, all-pairs ferromagnetic biimplication
    coupling w, shared bias toward 1 — single-site flips face a
    ``(n-1)·w`` barrier while the two joint modes differ by ``n·bias``."""
    dom = Domain([0, 1])
    spins = [RV(dom, name=f"s{i}") for i in range(n)]
    fs = [
        F(MLNPotential(lambda a: leq(a[0], a[1]), w=w), [spins[i], spins[j]])
        for i in range(n)
        for j in range(i + 1, n)
    ]
    fs += [F(MLNPotential(lambda a: a[0], w=bias), [s]) for s in spins]
    return Graph(spins, fs), spins


def test_plan_structure():
    g, spins = spin_clique()
    fg = compile_graph(g)
    plan = build_mode_swap_plan(fg)
    assert plan is not None and plan.n_groups == 1
    gvars = np.asarray(plan.vars_[0])
    assert sorted(gvars[gvars < fg.n_disc].tolist()) == [0, 1, 2, 3]
    # the clique's members are each other's neighbors, so F is empty and
    # every real (G-touching) row stays in the direct term
    assert not np.asarray(plan.f_mask).any()
    assert plan.direct_buckets == fg.disc_bucket_idx
    for w, bi in zip(plan.w_direct, plan.direct_buckets):
        np.testing.assert_array_equal(
            np.asarray(w[0]), np.asarray(fg.buckets[bi].scale)
        )


def test_plan_skips_uncoupled_classes():
    """A class whose members never co-occur in a row cannot mode-lock —
    no plan is built for independent spins."""
    dom = Domain([0, 1])
    spins = [RV(dom, name=f"u{i}") for i in range(4)]
    fs = [F(MLNPotential(lambda a: a[0], w=0.7), [s]) for s in spins]
    fg = compile_graph(Graph(spins, fs))
    assert build_mode_swap_plan(fg) is None


def test_plan_f_independence():
    """On the relational model: F members never share a factor row (the
    collapsed product would not factorize otherwise)."""
    from lhvi_tpu.models.relational import friends_smokers
    from lhvi_tpu.relational.fast import fast_compile

    rg = friends_smokers(n_people=10, hybrid=True)
    rg.observe("smokes", ("p0",), 1)
    fg = fast_compile(rg)
    plan = build_mode_swap_plan(fg)
    assert plan is not None
    fm = np.asarray(plan.f_mask)
    for gi in range(plan.n_groups):
        fset = np.concatenate([fm[gi], np.zeros(1, bool)])
        for np_b in fg.meta.np_buckets:
            real = np_b["scale"] > 0
            didx = np.where(np_b["disc_mask"] > 0, np_b["disc_idx"],
                            fg.n_disc)
            hits = fset[didx[real]].sum(axis=1)
            assert (hits <= 1).all(), "two F members share a factor row"
        # direct rows carry weight iff they touch G, avoid F, and are
        # real — anything else either lives in the F logits or cancels
        # in the accept delta
        gv = np.asarray(plan.vars_[gi])
        gset = np.zeros(fg.n_disc + 1, bool)
        gset[gv[gv < fg.n_disc]] = True
        for w, bi in zip(plan.w_direct, plan.direct_buckets):
            np_b = fg.meta.np_buckets[bi]
            didx = np.where(np_b["disc_mask"] > 0, np_b["disc_idx"],
                            fg.n_disc)
            keep = gset[didx].any(axis=1) & ~fset[didx].any(axis=1)
            scale = np.asarray(fg.buckets[bi].scale)
            np.testing.assert_array_equal(
                np.asarray(w[gi]), np.where(keep, scale, 0.0)
            )


def test_mode_swap_matches_enumeration():
    """Golden exactness: marginals on the suppressed-flip spin clique
    match exact enumeration. Gibbs alone crosses the 7.5-nat barrier
    rarely; the collapsed flip restores mixing without biasing the
    stationary distribution."""
    g, spins = spin_clique(n=4, w=2.5, bias=0.4)
    exact = ExactPosterior(g)
    fg = compile_graph(g)
    res = hmc.sample(
        fg,
        jax.random.PRNGKey(3),
        n_chains=32,
        n_warmup=200,
        n_samples=1500,
        cfg=hmc.HMCConfig(mode_swap=True),
    )
    assert float(res.diag["mode_swap_accept"]) > 0.05
    for s in spins:
        pd = res.disc_marginal(s)
        np.testing.assert_allclose(pd, exact.disc_marginal(s), atol=0.04)


def test_mode_swap_invariance_strong_lock():
    """At w=6 the barrier is ~18 nats (plain Gibbs never crosses); the
    move must still leave the target invariant — marginals match the
    enumerated two-mode mixture, not a single mode."""
    g, spins = spin_clique(n=4, w=6.0, bias=0.25)
    exact = ExactPosterior(g)
    fg = compile_graph(g)
    res = hmc.sample(
        fg,
        jax.random.PRNGKey(4),
        n_chains=64,
        n_warmup=100,
        n_samples=1500,
        cfg=hmc.HMCConfig(mode_swap=True),
    )
    p1_exact = exact.disc_marginal(spins[0])[1]
    p1 = res.disc_marginal(spins[0])[1]
    assert abs(p1 - p1_exact) < 0.05, (p1, p1_exact)
    # sanity: the two modes genuinely coexist in the exact answer
    assert 0.15 < p1_exact < 0.85


def test_mode_swap_every_gate_exact():
    """mode_swap_every=k applies the move with probability 1/k — a
    random-scan mixture kernel that must stay exact and still unlock the
    strongly locked clique (a stuck chain accepts its first proposal)."""
    g, spins = spin_clique(n=4, w=6.0, bias=0.25)
    exact = ExactPosterior(g)
    fg = compile_graph(g)
    res = hmc.sample(
        fg,
        jax.random.PRNGKey(11),
        n_chains=64,
        n_warmup=100,
        n_samples=1500,
        cfg=hmc.HMCConfig(mode_swap=True, mode_swap_every=3),
    )
    p1 = res.disc_marginal(spins[0])[1]
    assert abs(p1 - exact.disc_marginal(spins[0])[1]) < 0.06
    # the gate really thins applications: acceptance is still tracked
    # per application, so it should resemble the every=1 rate
    assert float(res.diag["mode_swap_accept"]) > 0.02


def test_nuts_mode_swap_matches_enumeration():
    """The NUTS-within-Gibbs wiring of the move (NUTSConfig.mode_swap
    routes through the same transition hook)."""
    from lhvi_tpu.engines import nuts

    g, spins = spin_clique(n=4, w=5.0, bias=0.3)
    exact = ExactPosterior(g)
    fg = compile_graph(g)
    res = nuts.sample(
        fg,
        jax.random.PRNGKey(9),
        n_chains=64,
        n_warmup=100,
        n_samples=1200,
        cfg=nuts.NUTSConfig(mode_swap=True),
    )
    p1 = res.disc_marginal(spins[0])[1]
    assert abs(p1 - exact.disc_marginal(spins[0])[1]) < 0.06
    assert float(res.diag["mode_swap_accept"]) > 0.02


def test_resume_bitwise_with_mode_swap(tmp_path):
    """The ms_acc accumulators (fmt-4 payload) and the move's RNG stream
    survive preemption: interrupted+resumed equals uninterrupted,
    bitwise, with the move active."""
    from lhvi_tpu.engines.resumable import sample_checkpointed

    g, spins = spin_clique(n=4, w=3.0, bias=0.3)
    fg = compile_graph(g)
    key = jax.random.PRNGKey(13)
    kw = dict(engine="hmc", cfg=hmc.HMCConfig(mode_swap=True),
              n_chains=8, n_warmup=40, n_samples=120, chunk_size=60)

    full = sample_checkpointed(fg, key, ckpt_dir=str(tmp_path / "f"), **kw)
    out = sample_checkpointed(fg, key, ckpt_dir=str(tmp_path / "p"),
                              _interrupt_after=0, **kw)
    assert out is None
    resumed = sample_checkpointed(fg, key, ckpt_dir=str(tmp_path / "p"),
                                  **kw)
    for k in ("mean", "var", "disc_probs"):
        assert np.array_equal(full.moments[k], resumed.moments[k]), k
    assert np.array_equal(full.diag["mode_swap_accept"],
                          resumed.diag["mode_swap_accept"])
    assert float(full.diag["mode_swap_accept"]) > 0.0


def test_smc_mode_swap_matches_enumeration():
    """The tempered variant: collapsed flips accepted against π^β during
    the anneal must leave the final target unbiased on the locked
    clique."""
    from lhvi_tpu.engines import smc

    g, spins = spin_clique(n=4, w=4.0, bias=0.3)
    exact = ExactPosterior(g)
    fg = compile_graph(g)
    res = smc.sample(
        fg, jax.random.PRNGKey(7),
        smc.SMCConfig(n_particles=2048, n_temps=25, n_moves=2,
                      mode_swap=True),
    )
    for s in spins:
        np.testing.assert_allclose(
            res.disc_marginal(s), exact.disc_marginal(s), atol=0.05
        )


def test_mode_swap_sharded_matches_unsharded():
    """The move is chain-parallel ([C]-row wheres, per-chain accept
    variates drawn shard-independently), so a sharded chain axis must
    reproduce the unsharded run — same rule as the planned-Gibbs
    identity in test_pod_sharded.py."""
    from lhvi_tpu.models.relational import friends_smokers
    from lhvi_tpu.parallel import chain_sharding, make_mesh
    from lhvi_tpu.relational.fast import fast_compile

    rg = friends_smokers(n_people=16, hybrid=True)
    for i in range(4):
        rg.observe("smokes", (f"p{i}",), i % 2)
    fg = fast_compile(rg)
    mesh = make_mesh(axis_names=("dp",))
    assert mesh.shape["dp"] >= 2
    cfg = hmc.HMCConfig(n_leapfrog=3, init_step_size=0.05,
                        adapt_mass=False, mode_swap=True)
    kw = dict(n_chains=16, n_warmup=0, n_samples=6, collect="moments")
    m0, _, d0 = hmc.run_hmc(fg, jax.random.PRNGKey(0), cfg, **kw)
    m1, _, d1 = hmc.run_hmc(fg, jax.random.PRNGKey(0), cfg,
                            shard=chain_sharding(mesh), **kw)
    np.testing.assert_array_equal(
        np.asarray(m0["disc_probs"]), np.asarray(m1["disc_probs"])
    )
    np.testing.assert_allclose(
        np.asarray(m0["mean"]), np.asarray(m1["mean"]), rtol=1e-5,
        atol=1e-6,
    )
    np.testing.assert_allclose(
        float(d0["mode_swap_accept"]), float(d1["mode_swap_accept"]),
        rtol=1e-6,
    )


def test_pod_clique_unlocks():
    """The production failure: 16-person friends-smokers with evidence.
    Without the move every free smokes latent freezes per-chain; with it
    the frozen-and-disagreeing set empties (same budget, same seeds)."""
    from lhvi_tpu.models.relational import friends_smokers
    from lhvi_tpu.relational.fast import fast_compile

    rg = friends_smokers(n_people=16, hybrid=True)
    for i in range(4):
        rg.observe("smokes", (f"p{i}",), i % 2)
    fg = fast_compile(rg)

    def frozen_disagreeing(mode_swap):
        _, xd, _ = hmc.run_hmc(
            fg, jax.random.PRNGKey(0),
            hmc.HMCConfig(n_leapfrog=4, mode_swap=mode_swap),
            n_chains=8, n_warmup=40, n_samples=120, collect="samples",
        )
        xd = np.asarray(xd)
        frozen = (xd.var(axis=0) == 0).all(axis=0)
        return int((frozen & (xd[0].std(axis=0) > 0)).sum())

    assert frozen_disagreeing(False) > 0
    assert frozen_disagreeing(True) == 0
