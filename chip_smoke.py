"""Drive the sampler path once on the GPU at full model width.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

The first line is the card's name and power limit (``nvidia-smi``). Each
phase then prints one line: what ran, compile and run seconds apart, and
every compared value beside its bound. The last line is one JSON object,
``{"ok": true, "device": {...}}``. A failed check raises, so the script
exits non-zero without that line; it refuses to start without a GPU and
never falls back to the CPU.

Phases (one card): the Triton quad leapfrog against the XLA body and a
float64 leapfrog at the headline shape; headline grid HMC (65,536 chains)
and NUTS against the dense Gaussian oracle, with the end-to-end headline
rate of both leapfrog routes; annealed SMC log-Z against the exact
Gaussian normaliser; 128×128 sparse grid HMC on the DIA and the ELL path
against a sparse direct solve; lifted VI on friends-smokers-320; the pod
flagship (103k latents, mode-swap, streamed diagnostics, 128 chains) with
``mode_swap_every`` 1 and 2; every engine on the hybrid chain against
exact enumeration. With ``--four-cards``: pod320 HMC, grid HMC and grid
SMC sharded over a 1-D mesh of four cards, each against the same totals
on one card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# sizes of the full run; tests and rehearsals on the CPU pass smaller ones
FULL = dict(
    chains=65536, grid_warmup=200, grid_samples=200, rate_samples=100,
    nuts_chains=65536, nuts_warmup=100, nuts_samples=100,
    smc_particles=65536, smc_temps=50,
    sparse_side=128, sparse_chains=1024, sparse_warmup=200,
    sparse_samples=200,
    people=320, vi_iters=300, pod_chains=128, pod_samples=4,
)
SIGMOID_1P2 = 1.0 / (1.0 + math.exp(-1.2))  # cancer(p1) | smokes(p1)=1

# lowering and XLA compilation; tracing (which nests) counts as run time
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")
_compile_s = [0.0]


def _on_duration(event, secs, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += secs


class Phase:
    """Times one phase and prints its line: compile seconds (lowering and
    XLA compilation as JAX reports them) apart from the rest (tracing,
    host work and device execution)."""

    def __init__(self, name):
        self.name, self.checks, self.info = name, [], {}

    def __enter__(self):
        self.c0, self.t0 = _compile_s[0], time.perf_counter()
        return self

    def check(self, what, value, op, bound):
        value = float(value)
        ok = {"<": value < bound, ">": value > bound,
              "<=": value <= bound, "==": value == bound}[op]
        self.checks.append(f"{what}={value:.6g} ({op} {bound:g})")
        if not ok:
            raise AssertionError(f"{self.name}: {what}={value!r} not "
                                 f"{op} {bound}")

    def __exit__(self, *exc):
        if exc[0] is not None:
            return False
        wall = time.perf_counter() - self.t0
        comp = _compile_s[0] - self.c0
        extra = " ".join(f"{k}={v}" for k, v in self.info.items())
        print(f"phase {self.name}: compile_s={comp:.2f} "
              f"run_s={wall - comp:.2f} {extra} | "
              + "; ".join(self.checks), flush=True)
        return False


def _timed(fn):
    """(result, seconds) of ``fn()`` up to ``block_until_ready``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _grid():
    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines.gabp import dense_gaussian_marginals
    from lhvi_tpu.models.toy import gaussian_grid

    g, _ = gaussian_grid(rows=10, cols=10, seed=0, evidence_frac=0.2)
    fg = compile_graph(g)
    oracle, latents = dense_gaussian_marginals(g)
    idx = [fg.meta.loc(rv)[1] for rv in latents]
    mean = np.zeros(fg.n_cont)
    var = np.zeros(fg.n_cont)
    mean[idx] = [oracle[id(rv)][0] for rv in latents]
    var[idx] = [oracle[id(rv)][1] for rv in latents]
    return fg, mean, var


def _check_moments(ph, m, mean, var, mean_tol, var_tol):
    got_m = np.asarray(m["mean"], np.float64)
    got_v = np.asarray(m["var"], np.float64)
    ph.check("max|mean-oracle|", np.abs(got_m - mean).max(), "<", mean_tol)
    ph.check("max|var/oracle-1|", np.abs(got_v / var - 1).max(), "<",
             var_tol)


def _f64_leapfrog(x, p, J, h, eps, n_steps):
    x, p = np.asarray(x, np.float64), np.asarray(p, np.float64)
    J, h = np.asarray(J, np.float64), np.asarray(h, np.float64)
    p = p + 0.5 * eps * (h - x @ J)
    for i in range(n_steps):
        x = x + eps * p
        p = p + (0.5 if i == n_steps - 1 else 1.0) * eps * (h - x @ J)
    return x, p


def phase_kernel(fg, s, interpret=False):
    """Triton leapfrog vs the XLA body at the headline shape, and both vs
    float64 on 1,024 chains. The XLA body runs at ``Precision.HIGHEST``
    (IEEE f32). The kernel's dot is the three-pass TF32 algorithm
    (``TF32_TF32_F32_X3``), not IEEE f32: an IEEE f32 ``tl.dot`` runs
    without tensor cores and lost to XLA, while X3 keeps f32-grade error
    (checked here against float64). The XLA body given the same X3
    algorithm is timed too (GPU only; the CPU has no TF32), so the
    comparison also holds at equal precision."""
    import jax
    import jax.numpy as jnp
    from lhvi_tpu.ops import leapfrog as lf

    C, n, eps, steps = s["chains"], fg.n_cont, 0.12, 8
    J, h, im = fg.quad_J, fg.quad_h, jnp.ones(fg.n_cont)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(C, n)), jnp.float32)
    p = jnp.asarray(rng.normal(size=(C, n)), jnp.float32)
    with Phase(f"leapfrog_kernel [{C},{n}] n_steps={steps} eps={eps}") as ph:
        fns = {
            "xla": jax.jit(lambda x, p: lf._jnp_quad_leapfrog(
                x, p, J, h, im, eps, steps)),
            "triton": jax.jit(lambda x, p: lf._triton_quad_leapfrog(
                x, p, J, h, im, eps, steps, interpret=interpret)),
        }
        if not interpret:
            fns["xla_x3"] = jax.jit(lambda x, p: lf._jnp_quad_leapfrog(
                x, p, J, h, im, eps, steps, precision=lf._KERNEL_DOT))
        out = {k: _timed(lambda f=f: f(x, p))[0] for k, f in fns.items()}
        for k, f in fns.items():
            t = min(_timed(lambda: f(x, p))[1] for _ in range(5))
            ph.info[f"{k}_ms"] = f"{t * 1e3:.4f}"
        ph.info.update(kernel_dot=str(lf._KERNEL_DOT).split(".")[-1],
                       xla_precision="HIGHEST")
        fx, fp = _f64_leapfrog(x[:1024], p[:1024], J, h, eps, steps)
        pairs = [("triton-vs-xla", out["triton"], out["xla"], 1e-5)]
        pairs += [(f"{k}-vs-f64", (out[k][0][:1024], out[k][1][:1024]),
                   (fx, fp), 1e-4) for k in fns]
        for name, (ax, ap), (bx, bp), tol in pairs:
            for a, b in ((ax, bx), (ap, bp)):
                a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
                # allclose form: |a-b| <= atol + rtol*|b| with rtol=atol=tol
                ph.check(f"{name} max(|d|/(1+|ref|))",
                         np.max(np.abs(a - b) / (1.0 + np.abs(b))), "<", tol)


def _hmc_rate(fg, cfg, C, samples, key=1):
    from lhvi_tpu.engines import hmc
    import jax

    run = lambda k: hmc.run_hmc(fg, jax.random.PRNGKey(k), cfg, n_chains=C,
                                n_warmup=0, n_samples=samples,
                                collect="moments", stream_diag=False)
    _timed(lambda: run(0))
    return C * samples / min(_timed(lambda: run(key + r))[1] for r in range(3))


def phase_grid_hmc(fg, mean, var, s):
    """Headline grid HMC against the dense oracle, plus the end-to-end
    headline rate of each leapfrog route (XLA, Triton, Triton, XLA)."""
    import jax
    from lhvi_tpu.engines import hmc
    from lhvi_tpu.ops import leapfrog as lf

    C = s["chains"]
    cfg = hmc.HMCConfig(n_leapfrog=8, init_step_size=0.12)
    with Phase(f"grid_hmc 10x10 chains={C}") as ph:
        m, _, diag = hmc.run_hmc(fg, jax.random.PRNGKey(0), cfg,
                                 n_chains=C, n_warmup=s["grid_warmup"],
                                 n_samples=s["grid_samples"],
                                 collect="moments")
        jax.block_until_ready(m)
        ph.check("accept", diag["accept_rate"], ">", 0.3)
        _check_moments(ph, m, mean, var, 0.03, 0.05)
        ph.check("max rhat", np.max(np.asarray(diag["rhat"])), "<", 1.05)
    kernel = lf.use_triton
    rates = {}
    with Phase(f"headline_rate chains={C} samples={s['rate_samples']}") as ph:
        try:
            for route in ("xla", "triton", "triton", "xla"):
                lf.use_triton = (kernel if route == "triton"
                                 else lambda n, backend=None: False)
                jax.clear_caches()
                rates.setdefault(route, []).append(
                    _hmc_rate(fg, cfg, C, s["rate_samples"]))
        finally:
            lf.use_triton = kernel
            jax.clear_caches()
        for route, r in rates.items():
            ph.info[f"{route}_samples_per_s"] = " ".join(f"{v:.1f}"
                                                        for v in r)
        ph.info["kernel_in_use"] = kernel(fg.n_cont)


def phase_grid_nuts(fg, mean, var, s):
    import jax
    from lhvi_tpu.engines import nuts

    C = s["nuts_chains"]
    cfg = nuts.NUTSConfig(max_depth=4, init_step_size=0.12)
    with Phase(f"grid_nuts 10x10 chains={C} max_depth=4") as ph:
        (m, _, diag), dt = _timed(lambda: nuts.run_nuts(
            fg, jax.random.PRNGKey(0), cfg, n_chains=C,
            n_warmup=s["nuts_warmup"], n_samples=s["nuts_samples"],
            collect="moments"))
        _check_moments(ph, m, mean, var, 0.03, 0.05)
        ph.check("accept", diag["accept_rate"], ">", 0.3)
        ph.info["mean_depth"] = f"{float(diag['mean_depth']):.3f}"
        ph.info["chain_samples_per_s_incl_compile"] = (
            f"{C * (s['nuts_warmup'] + s['nuts_samples']) / dt:.1f}")
        (_, _, _), dt2 = _timed(lambda: nuts.run_nuts(
            fg, jax.random.PRNGKey(1), cfg, n_chains=C,
            n_warmup=s["nuts_warmup"], n_samples=s["nuts_samples"],
            collect="moments"))
        ph.info["chain_samples_per_s"] = (
            f"{C * (s['nuts_warmup'] + s['nuts_samples']) / dt2:.1f}")


def exact_log_z(fg):
    """log ∫ exp(c + h·x − ½ xᵀJx) dx in float64 for the fused form."""
    J = np.asarray(fg.quad_J, np.float64)
    h = np.asarray(fg.quad_h, np.float64)
    n = J.shape[0]
    _, logdet = np.linalg.slogdet(J)
    return (float(fg.quad_c) + 0.5 * h @ np.linalg.solve(J, h)
            + 0.5 * n * math.log(2 * math.pi) - 0.5 * logdet)


def phase_grid_smc(fg, s, shard=None, tag=""):
    import jax
    from lhvi_tpu.engines import smc

    N, T = s["smc_particles"], s["smc_temps"]
    cfg = smc.SMCConfig(n_particles=N, n_temps=T)
    with Phase(f"grid_smc{tag} 10x10 particles={N} temps={T}") as ph:
        out = jax.block_until_ready(
            smc.run_smc(fg, jax.random.PRNGKey(0), cfg, shard=shard))
        lz = float(out[3])
        ph.check("|log_z-exact|", abs(lz - exact_log_z(fg)), "<", 0.1)
    return lz


def _sparse_oracle(g, n_spot=64):
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    from lhvi_tpu.engines import gabp

    Jd, h, off, latents = gabp.sparse_information_form(g)
    n = len(latents)
    items = list(off.items())
    rows = np.array([k[0] for k, _ in items] + list(range(n)))
    cols = np.array([k[1] for k, _ in items] + list(range(n)))
    vals = np.array([v for _, v in items] + list(Jd))
    lu = spla.splu(sp.csc_matrix((vals, (rows, cols)), shape=(n, n)))
    spot = np.random.default_rng(0).choice(n, n_spot, replace=False)
    var = np.array([lu.solve(np.eye(n, 1, -int(i)).ravel())[i]
                    for i in spot])
    return lu.solve(h), spot, var


def phase_sparse(s):
    """128×128 evidence grid (past the dense cap) on the DIA and the ELL
    path, against a sparse direct solve (means at every dim, variances at
    64 spot dims); bounds as in tests/test_ell_oracle.py."""
    import jax
    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import hmc
    from lhvi_tpu.models.toy import gaussian_grid

    side, C = s["sparse_side"], s["sparse_chains"]
    g, _ = gaussian_grid(rows=side, cols=side, seed=1, evidence_frac=0.05)
    fg = compile_graph(g)
    assert fg.quad_sparse and fg.quad_dia_offsets is not None
    mean, spot, var = _sparse_oracle(g)
    for dia in (True, False):
        cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.05,
                            dia_kernel=dia)
        name = "dia" if dia else "ell"
        with Phase(f"sparse_hmc_{name} {side}x{side} n={fg.n_cont} "
                   f"chains={C}") as ph:
            run = lambda k: hmc.run_hmc(
                fg, jax.random.PRNGKey(k), cfg, n_chains=C,
                n_warmup=s["sparse_warmup"], n_samples=s["sparse_samples"],
                collect="moments")
            (m, _, diag), _ = _timed(lambda: run(0))
            (_, _, _), dt = _timed(lambda: run(1))
            ph.info["chain_transitions_per_s"] = (
                f"{C * (s['sparse_warmup'] + s['sparse_samples']) / dt:.1f}")
            ph.check("accept", diag["accept_rate"], ">", 0.6)
            err = np.abs(np.asarray(m["mean"], np.float64) - mean)
            ph.check("mean|mean-exact|", err.mean(), "<", 0.05)
            ph.check("max|mean-exact|", err.max(), "<", 0.25)
            rel = np.abs(np.asarray(m["var"], np.float64)[spot] / var - 1)
            ph.check("mean|var/exact-1|", rel.mean(), "<", 0.10)
            ph.check("max|var/exact-1|", rel.max(), "<", 0.35)


def _friends_smokers(people):
    from lhvi_tpu.models.relational import friends_smokers

    rg = friends_smokers(n_people=people, hybrid=True)
    for i in range(16):
        rg.observe("smokes", (f"p{i}",), i % 2)
    return rg


def phase_lifted_vi(s):
    import jax
    from lhvi_tpu.engines import vi
    from lhvi_tpu.lift import compile_lifted

    with Phase(f"lifted_vi friends_smokers({s['people']}) "
               f"iters={s['vi_iters']}") as ph:
        t0 = time.perf_counter()
        g, index = _friends_smokers(s["people"]).ground()
        fg_l = compile_lifted(g)
        ph.info["ground_lift_host_s"] = f"{time.perf_counter() - t0:.2f}"
        res = vi.infer(fg_l, jax.random.PRNGKey(0),
                       vi.VIConfig(K=4, n_iters=s["vi_iters"], lr=5e-2))
        ph.check("elbo finite", np.isfinite(float(res.trace[-1])), "==", 1)
        p1 = float(res.disc_marginal(index[("cancer", ("p1",))])[1])
        ph.check("|P(cancer(p1))-sigmoid(1.2)|", abs(p1 - SIGMOID_1P2),
                 "<", 0.05)


def pod_fg(people):
    from lhvi_tpu.relational.fast import fast_compile

    return fast_compile(_friends_smokers(people))


def _pod_cfg(every):
    from lhvi_tpu.engines import hmc

    return hmc.HMCConfig(n_leapfrog=6, init_step_size=0.1, mode_swap=True,
                         mode_swap_every=every)


def _pod_run(fg, s, every, shard=None):
    import jax
    from lhvi_tpu.engines import hmc

    return jax.block_until_ready(hmc.run_hmc(
        fg, jax.random.PRNGKey(0), _pod_cfg(every), n_chains=s["pod_chains"],
        n_warmup=0, n_samples=s["pod_samples"], collect="moments",
        stream_diag=True, shard=shard))


def _start_var(fg, cfg):
    """Per-dim variance of the continuous start state
    (``CompiledFG.init_state_batched``: jitter · min(span, 4) · N(0, 1))."""
    span = np.minimum(np.asarray(fg.cont_hi) - np.asarray(fg.cont_lo), 4.0)
    return (cfg.jitter * span) ** 2


def _check_pod(ph, fg, out):
    m, _, diag = out
    for k in ("mean", "var", "disc_probs"):
        ph.check(f"{k} finite", np.isfinite(np.asarray(m[k])).all(), "==", 1)
    # The chains start at variance 16 against a posterior near N(0, 1)
    # and take no warmup, so every proposal falls inward; the leapfrog's
    # energy error is then negative (its shadow Hamiltonian keeps
    # ΔH ≈ (ε²/8)·(|x1|² − |x0|²)), min(1, exp(−ΔH)) is exactly 1, and
    # the mean is 1.0. The variance check shows the moves are real: a
    # continuous move that did nothing would leave it at the start value.
    ph.check("accept", diag["accept_rate"], ">", 0.3)
    ph.check("accept", diag["accept_rate"], "<=", 1.0)
    shrink = np.mean(np.asarray(m["var"], np.float64)
                     / _start_var(fg, _pod_cfg(1)))
    ph.check("mean(var/start_var)", shrink, "<", 0.75)
    for k in ("rhat", "rhat_disc"):
        ph.check(f"{k} finite", np.isfinite(np.asarray(diag[k])).all(),
                 "==", 1)


def _pod_energy_probe(ph, fg, C):
    """One continuous proposal from the production run's start state:
    the energy change ΔH = H(x1, p1) − H(x0, p0) and how far x moved."""
    import jax
    import jax.numpy as jnp
    from lhvi_tpu.engines import hmc
    from lhvi_tpu.ops.logpot import logpot_leapfrog

    cfg = _pod_cfg(1)
    st = hmc.init_hmc_state(fg, jax.random.split(jax.random.PRNGKey(0), 3)[0],
                            cfg, C)

    @jax.jit
    def probe(fg, xc, xd, p0):
        x1, p1, lp0, lp1 = logpot_leapfrog(fg, xc, p0, xd, st.inv_mass,
                                           cfg.init_step_size, cfg.n_leapfrog)
        ke = lambda p: 0.5 * jnp.sum(p * p, axis=-1)
        return (lp0 - ke(p0)) - (lp1 - ke(p1)), jnp.mean(jnp.abs(x1 - xc))

    dh, moved = probe(fg, st.xc, st.xd,
                      jax.random.normal(jax.random.PRNGKey(1), st.xc.shape))
    dh = np.asarray(dh, np.float64)
    ph.info.update(start_mean_dH=f"{dh.mean():.6g}",
                   start_frac_dH_neg=f"{np.mean(dh < 0):.4f}")
    ph.check("start max|dH|", np.abs(dh).max(), ">", 1e-3)
    ph.check("start mean|x1-x0|", moved, ">", 0.05)


def phase_pod(s):
    from lhvi_tpu.engines.modeswap import plan_for

    t0 = time.perf_counter()
    fg = pod_fg(s["people"])
    fg = fg.replace(mode_swap_plan=plan_for(fg))
    host = time.perf_counter() - t0
    for every in (1, 2):
        with Phase(f"pod{s['people']} latents={fg.n_cont + fg.n_disc} "
                   f"chains={s['pod_chains']} samples={s['pod_samples']} "
                   f"mode_swap_every={every} stream_diag") as ph:
            ph.info["fast_compile_plan_host_s"] = f"{host:.2f}"
            if every == 1:
                _pod_energy_probe(ph, fg, s["pod_chains"])
            out = _pod_run(fg, s, every)
            _check_pod(ph, fg, out)
            ph.info["mode_swap_accept"] = (
                f"{float(out[2]['mode_swap_accept']):.4f}")
    return fg


def phase_engines():
    """Every engine on the 3-variable hybrid chain against exact
    enumeration (examples/demo.py)."""
    import jax
    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import hmc, nuts, smc, vi
    from lhvi_tpu.engines.epbp import EPBP, EPBPConfig
    from lhvi_tpu.engines.lbp import HybridLBP
    from lhvi_tpu.engines.map_search import HybridMaxWalkSAT
    from lhvi_tpu.models.toy import hybrid_chain
    from lhvi_tpu.utils.oracle import ExactPosterior

    g, (d, x1, x2) = hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    fg = compile_graph(g)
    key = jax.random.PRNGKey(0)
    runs = {
        "nuts": lambda: nuts.sample(fg, key, n_chains=16, n_warmup=300,
                                    n_samples=600),
        "hmc": lambda: hmc.sample(fg, key, n_chains=32, n_warmup=400,
                                  n_samples=1000),
        "vi": lambda: vi.infer(fg, key, vi.VIConfig(K=8, n_iters=1500)),
        "smc": lambda: smc.sample(fg, key, smc.SMCConfig(n_particles=4096,
                                                         n_temps=40)),
        "lbp": lambda: HybridLBP(fg).run(30),
        "epbp": lambda: EPBP(fg, EPBPConfig(128, 40)).run(key),
    }
    # (mean, P(d=1)) bounds: tests/test_smc.py's hybrid-chain bounds;
    # EPBP's single particle set at P=128 as in tests/test_epbp.py
    tols = {"epbp": (0.22, 0.08)}
    for name, run in runs.items():
        with Phase(f"hybrid_chain_{name}") as ph:
            res = run()
            mean_tol, disc_tol = tols.get(name, (0.1, 0.06))
            ph.check("max|E[x]-exact|", max(
                abs(res.mean(x1) - exact.mean(x1)),
                abs(res.mean(x2) - exact.mean(x2))), "<", mean_tol)
            ph.check("|P(d=1)-exact|", abs(
                res.disc_marginal(d)[1] - exact.disc_marginal(d)[1]),
                "<", disc_tol)
    with Phase("hybrid_chain_mws") as ph:
        res = HybridMaxWalkSAT(fg).run(key)
        want = exact.map_state()
        ph.check("d* == exact", res.map(d) == want[d], "==", 1)
        ph.check("|x1*-exact|", abs(res.map(x1) - want[x1]), "<", 0.25)


def one_card(s=FULL, interpret=False):
    fg, mean, var = _grid()
    phase_kernel(fg, s, interpret)
    phase_grid_hmc(fg, mean, var, s)
    phase_grid_nuts(fg, mean, var, s)
    phase_grid_smc(fg, s)
    phase_sparse(s)
    phase_lifted_vi(s)
    phase_pod(s)
    phase_engines()


def four_cards(s=FULL):
    """The sharded paths on a 1-D ``dp`` mesh of every visible card, each
    against the same totals on one card."""
    import jax
    from lhvi_tpu.engines import hmc
    from lhvi_tpu.engines.modeswap import plan_for
    from lhvi_tpu.parallel import chain_sharding, make_mesh

    shard = chain_sharding(make_mesh(axis_names=("dp",)))
    n_dev = len(jax.devices())
    fg, mean, var = _grid()
    C = s["chains"]
    cfg = hmc.HMCConfig(n_leapfrog=8, init_step_size=0.12)
    outs = {}
    for tag, sh in (("1card", None), (f"{n_dev}cards", shard)):
        with Phase(f"grid_hmc_{tag} chains={C}") as ph:
            run = lambda k: hmc.run_hmc(
                fg, jax.random.PRNGKey(k), cfg, n_chains=C,
                n_warmup=s["grid_warmup"], n_samples=s["grid_samples"],
                collect="moments", shard=sh)
            (m, _, diag), _ = _timed(lambda: run(0))
            (_, _, _), dt = _timed(lambda: run(1))
            ph.info["chain_transitions_per_s"] = (
                f"{C * (s['grid_warmup'] + s['grid_samples']) / dt:.1f}")
            _check_moments(ph, m, mean, var, 0.03, 0.05)
            outs[tag] = m
    with Phase(f"grid_hmc_{n_dev}cards_vs_1card") as ph:
        d = np.abs(np.asarray(outs["1card"]["mean"])
                   - np.asarray(outs[f"{n_dev}cards"]["mean"]))
        ph.check("max|Δmean|", d.max(), "<", 0.03)
    lz1 = phase_grid_smc(fg, s, tag="_1card")
    lzn = phase_grid_smc(fg, s, shard=shard, tag=f"_{n_dev}cards")
    with Phase(f"grid_smc_{n_dev}cards_vs_1card") as ph:
        ph.check("|Δlog_z|", abs(lz1 - lzn), "<", 0.1)
    pfg = pod_fg(s["people"])
    pfg = pfg.replace(mode_swap_plan=plan_for(pfg))
    pods = {}
    for tag, sh in (("1card", None), (f"{n_dev}cards", shard)):
        with Phase(f"pod{s['people']}_{tag} chains={s['pod_chains']} "
                   f"samples={s['pod_samples']} mode_swap stream_diag") as ph:
            pods[tag] = _pod_run(pfg, s, 1, shard=sh)
            _check_pod(ph, pfg, pods[tag])
    with Phase(f"pod{s['people']}_{n_dev}cards_vs_1card") as ph:
        a, b = (pods[t][0] for t in ("1card", f"{n_dev}cards"))
        # 128 chains × 4 draws: per-variable MC se ≈ 0.022 on a disc prob
        # and ≈ 0.044 on a unit-variance mean; the mean |Δ| over all
        # variables of two independent runs is ≈ 1.13 se
        ph.check("mean|Δdisc_probs|", np.mean(np.abs(
            np.asarray(a["disc_probs"]) - np.asarray(b["disc_probs"]))),
            "<", 0.06)
        ph.check("mean|Δmean|", np.mean(np.abs(
            np.asarray(a["mean"]) - np.asarray(b["mean"]))), "<", 0.15)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    want = 4 if args.four_cards else 1
    if devs[0].platform != "gpu" or len(devs) < want:
        print(f"chip_smoke: needs {want} GPU(s), JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)

    from lhvi_tpu.utils.cache import enable_compile_cache

    print(f"jax {jax.__version__} cache={enable_compile_cache()} "
          f"devices={len(devs)} kind={devs[0].device_kind}", flush=True)
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    t0 = time.perf_counter()
    if args.four_cards:
        four_cards()
    else:
        one_card()
    print(f"total_s={time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
