"""Benchmark harness (driver contract: print ONE JSON line).

Headline metric: HMC samples/s/chip on the 10×10 Gaussian-grid MRF with
evidence (BASELINE config 2) — one sample = one full HMC iteration of one
chain (leapfrog(8) + accept), 65536 chains batched on the chip.

Extra fields (same JSON line, full BASELINE metric set):
  nuts_samples_per_s      NUTS on the same grid, 65536 chains, max_depth=4
  smc_particles_per_s     annealed-SMC particle-temperature-steps/s
                          (8192 particles × 50 temperatures on the grid)
  vi_steps_per_s          fused closed-form ELBO Adam steps/s (grid, K=8)
  vi_lifted_steps_per_s   lifted quadrature-ELBO steps/s on the 103k-var
                          friends-smokers-320 model (18 orbits, K=4)
  hmc_nonquad_robot_samples_per_s
                          NON-quadratic HMC-within-Gibbs iterations/s on
                          the robot-mapping HMLN (16384 chains)
  pod_gibbs_chain_samples_per_s
                          pod-scale flagship (BASELINE config 5):
                          chain-samples/s on the 103k-latent hybrid MLN,
                          each sample = one FULL exact chromatic sweep
                          over 102,688 discrete latents + one HMC step
                          (128 chains)

The JSON line names the device it ran on. The harness refuses to run
without a GPU, and exits non-zero (after printing the line, with the
errors on stderr) if any cell raised.

``vs_baseline``: the reference is a single-machine pure-Python/numpy
codebase with no published numbers (BASELINE.md), so the baseline is a
faithful single-thread numpy implementation of the same sampler on the same
model, timed here on the host CPU — i.e. "how much faster than the
reference's technology stack on this model".
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


N_CHAINS = 65536
N_LEAPFROG = 8
STEP = 0.12
N_ITERS = 100
N_ITERS_NP = 6


def build_model():
    from lhvi_tpu.models.toy import gaussian_grid

    g, _ = gaussian_grid(rows=10, cols=10, seed=0, evidence_frac=0.2)
    return g


def numpy_baseline(g, iters=N_ITERS_NP, chains=8):
    """Reference-class implementation: per-chain Python loop, numpy math."""
    from lhvi_tpu.engines.gabp import information_form

    J, h, latents = information_form(g)
    n = len(latents)
    rng = np.random.default_rng(0)

    def logp(x):
        return -0.5 * x @ J @ x + h @ x

    def grad(x):
        return h - J @ x

    t0 = time.perf_counter()
    for c in range(chains):
        x = rng.normal(0, 1, n)
        for _ in range(iters):
            p = rng.normal(0, 1, n)
            x1, p1 = x.copy(), p.copy()
            for _ in range(N_LEAPFROG):
                p1 += 0.5 * STEP * grad(x1)
                x1 += STEP * p1
                p1 += 0.5 * STEP * grad(x1)
            h0 = -logp(x) + 0.5 * p @ p
            h1 = -logp(x1) + 0.5 * p1 @ p1
            if np.log(rng.uniform()) < min(0.0, h0 - h1):
                x = x1
    dt = time.perf_counter() - t0
    return chains * iters / dt  # samples/s


def headline_throughput(g):
    import jax

    # rbg PRNG (same statistics as threefry, cheaper bits). It stays set
    # for every later cell in this process.
    jax.config.update("jax_default_prng_impl", "rbg")

    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import hmc

    fg = compile_graph(g)
    cfg = hmc.HMCConfig(n_leapfrog=N_LEAPFROG, init_step_size=STEP)

    def run(key, n_samples):
        moments, _, diag = hmc.run_hmc(
            fg, key, cfg,
            n_chains=N_CHAINS, n_warmup=0, n_samples=n_samples,
            collect="moments", stream_diag=False,
        )
        return moments, diag

    # warm-up with the SAME static shapes so the timed calls are execution
    # only
    jax.block_until_ready(run(jax.random.PRNGKey(0), N_ITERS))
    times = []
    for rep in range(3):
        t0 = time.perf_counter()
        out, diag = jax.block_until_ready(
            run(jax.random.PRNGKey(1 + rep), N_ITERS))
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[1]  # median of 3
    global LAST_SPREAD
    LAST_SPREAD = round((max(times) - min(times)) / max(dt, 1e-9), 3)
    return N_CHAINS * N_ITERS / dt, diag


# relative rep spread ((max−min)/median) of the most recent _timed call —
# the main loop snapshots it per metric into the JSON line so the driver
# can tell a noisy measurement from a tight one
LAST_SPREAD = None


def _timed(fn, reps=3):
    """Median-of-``reps`` wall time of ``fn(rep)`` up to
    ``block_until_ready``."""
    import jax

    global LAST_SPREAD
    # warm-up: same static shapes, so timed calls are execution only
    jax.block_until_ready(fn(0))
    times = []
    for rep in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(1 + rep))
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    LAST_SPREAD = round((max(times) - min(times)) / max(med, 1e-9), 3)
    return med


def calib_matmul_ms():
    """Calibration sentinel: median-of-3 wall time of a PINNED reference
    workload — 24 chained 2048² f32 matmuls — with the same sync as every
    metric. The workload never changes, so movement in this number
    measures the machine (clocks, power limit, host contention), not the
    code."""
    import jax
    import jax.numpy as jnp

    a = jnp.ones((2048, 2048), jnp.float32) * 1e-3

    @jax.jit
    def work(a):
        def body(_, x):
            return x @ a * 1e-3 + 1.0
        return jax.lax.fori_loop(0, 24, body, a)

    def run(rep):
        return work(a + rep * 1e-6)

    dt = _timed(run)
    return dt * 1e3


def nuts_throughput(g):
    import jax
    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import nuts

    fg = compile_graph(g)
    cfg = nuts.NUTSConfig(max_depth=4, init_step_size=STEP, adapt_mass=False)
    n_samples = 50

    def run(rep):
        moments, _, diag = nuts.run_nuts(
            fg, jax.random.PRNGKey(rep), cfg,
            n_chains=N_CHAINS, n_warmup=0, n_samples=n_samples,
            collect="moments", stream_diag=False,
        )
        return moments

    dt = _timed(run)
    return N_CHAINS * n_samples / dt


def smc_throughput(g):
    import jax
    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import smc

    fg = compile_graph(g)
    # 65536 particles: same per-particle cost as 8192 but ~2.6x the
    # throughput (the anneal is reweight/resample-latency-bound, so more
    # particles amortize the fixed per-temperature cost)
    cfg = smc.SMCConfig(n_particles=65536, n_temps=50)

    def run(rep):
        xc, xd, log_w, log_z, diag = smc.run_smc(
            fg, jax.random.PRNGKey(rep), cfg
        )
        return log_z

    dt = _timed(run)
    return cfg.n_particles * cfg.n_temps / dt


def vi_throughput(g):
    import jax
    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import vi

    fg = compile_graph(g)
    cfg = vi.VIConfig(K=8, n_iters=1000)

    def run(rep):
        params, trace = vi.fit(fg, jax.random.PRNGKey(rep), cfg)
        return trace

    dt = _timed(run)
    return cfg.n_iters / dt


def vi_lifted_throughput(n_people=320):
    import jax
    from lhvi_tpu.engines import vi
    from lhvi_tpu.lift import compile_lifted
    from lhvi_tpu.models.relational import friends_smokers

    rg = friends_smokers(n_people=n_people, hybrid=True)
    for i in range(max(2, n_people // 10)):
        rg.observe("smokes", (f"p{i}",), i % 2)
    g, _ = rg.ground()
    fg_l = compile_lifted(g)
    # 1500 iters: the 18-orbit lifted ELBO step is so cheap that a short
    # fit is dominated by the one dispatch+sync round-trip; the longer
    # scan amortizes it, so the metric is steady-state steps/s.
    cfg = vi.VIConfig(K=4, n_iters=1500)

    def run(rep):
        params, trace = vi.fit(fg_l, jax.random.PRNGKey(rep), cfg)
        return trace

    dt = _timed(run)
    return cfg.n_iters / dt


def hmc_robot_throughput(n_segments=100, n_chains=16384):
    """NON-quadratic HMC-within-Gibbs on the robot-mapping HMLN
    (hybrid MLN potentials + discrete type latents): full iterations/s
    through the public run_hmc path — exercises the batched non-quad
    leapfrog (ops/logpot.py) and the chromatic Gibbs plan."""
    import jax
    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import hmc
    from lhvi_tpu.models.relational import robot_map, robot_scan_evidence
    from lhvi_tpu.relational.data import load_evidence

    text, _ = robot_scan_evidence(n_segments, seed=0)
    g, _ = robot_map(n_segments, evidence=load_evidence(text)).ground()
    fg = compile_graph(g)
    cfg = hmc.HMCConfig(n_leapfrog=N_LEAPFROG, init_step_size=0.05)
    n_samples = 50

    def run(rep):
        moments, _, _ = hmc.run_hmc(
            fg, jax.random.PRNGKey(rep), cfg,
            n_chains=n_chains, n_warmup=0, n_samples=n_samples,
            collect="moments", stream_diag=False,
        )
        return moments

    dt = _timed(run)
    return n_chains * n_samples / dt


def nuts_robot_throughput(n_segments=100, n_chains=16384):
    """NON-quadratic NUTS-within-Gibbs on the robot-mapping HMLN: full
    iterations/s through the public run_nuts path — exercises the
    lockstep batched XLA tree sweep on a non-quadratic target."""
    import jax
    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import nuts
    from lhvi_tpu.models.relational import robot_map, robot_scan_evidence
    from lhvi_tpu.relational.data import load_evidence

    text, _ = robot_scan_evidence(n_segments, seed=0)
    g, _ = robot_map(n_segments, evidence=load_evidence(text)).ground()
    fg = compile_graph(g)
    cfg = nuts.NUTSConfig(max_depth=4, init_step_size=0.05,
                          adapt_mass=False)
    n_samples = 20

    def run(rep):
        moments, _, _ = nuts.run_nuts(
            fg, jax.random.PRNGKey(rep), cfg,
            n_chains=n_chains, n_warmup=0, n_samples=n_samples,
            collect="moments", stream_diag=False,
        )
        return moments

    dt = _timed(run)
    return n_chains * n_samples / dt


def hmc_sparse_grid_throughput(rows=128, cols=128, n_chains=1024):
    """HMC on the 128×128 Gaussian grid (16k vars, past quad_max_n):
    guards the sparse fused path — banded (DIA) shift-multiply-accumulate
    matvec + position-Verlet leapfrog (HMCConfig.dia_kernel default)."""
    import jax
    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import hmc
    from lhvi_tpu.models.toy import gaussian_grid

    g, _ = gaussian_grid(rows=rows, cols=cols, seed=0, evidence_frac=0.2)
    fg = compile_graph(g)
    assert fg.quad_sparse, "128x128 grid must land on the ELL path"
    cfg = hmc.HMCConfig(n_leapfrog=N_LEAPFROG, init_step_size=0.05)
    n_samples = 20

    def run(rep):
        moments, _, _ = hmc.run_hmc(
            fg, jax.random.PRNGKey(rep), cfg,
            n_chains=n_chains, n_warmup=0, n_samples=n_samples,
            collect="moments", stream_diag=False,
        )
        return moments

    dt = _timed(run)
    return n_chains * n_samples / dt


def pod_gibbs_throughput(n_people=320, n_chains=128, chunk=16):
    """Pod-scale flagship (BASELINE config 5): full exact chromatic
    Gibbs sweep over ~1e5 discrete latents + HMC step, chain-samples/s
    through the public run_hmc path (vectorized relational->IR
    grounding, value-space per-color sweep plan).

    chunk = samples per device dispatch: each dispatch pays one
    dispatch+sync round-trip, which chunk=16 amortizes. The
    600/1000-people scale fields keep chunk=1 (their multi-sample
    programs are the longest compiles)."""
    import jax
    from lhvi_tpu.engines import hmc
    from lhvi_tpu.models.relational import friends_smokers
    from lhvi_tpu.relational.fast import fast_compile

    rg = friends_smokers(n_people=n_people, hybrid=True)
    for i in range(n_people // 10):
        rg.observe("smokes", (f"p{i}",), i % 2)
    fg = fast_compile(rg)
    cfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.1)

    def run(rep):
        moments, _, _ = hmc.run_hmc(
            fg, jax.random.PRNGKey(rep), cfg,
            n_chains=n_chains, n_warmup=0, n_samples=chunk,
            collect="moments", stream_diag=False,
        )
        return moments

    dt = _timed(run)
    return n_chains * chunk / dt


def main():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 2
    from lhvi_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    spreads, errors = {}, []

    def cell(name, fn):
        global LAST_SPREAD
        LAST_SPREAD = None
        try:
            value = fn()
        except Exception as e:  # noqa: BLE001 — reported, exit non-zero
            errors.append(name)
            print(f"# {name} failed: {e!r}"[:2000], file=sys.stderr)
            value = None
        if LAST_SPREAD is not None:
            spreads[name] = LAST_SPREAD
        jax.clear_caches()
        return value

    # calibration sentinel FIRST: pins the machine state the metrics below
    # were captured in
    calib_start = cell("calib_matmul_ms", calib_matmul_ms)
    g = build_model()
    headline = cell("headline", lambda: headline_throughput(g)[0])
    base_sps = numpy_baseline(g)
    out = {
        "metric": "hmc_grid10x10_samples_per_s_per_chip",
        "value": None if headline is None else round(headline, 1),
        "unit": "samples/s/chip",
        "vs_baseline": (None if headline is None
                        else round(headline / base_sps, 2)),
        "calib_matmul_ms": (None if calib_start is None
                            else round(calib_start, 2)),
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
    }
    for name, fn in (
        ("nuts_samples_per_s", lambda: nuts_throughput(g)),
        ("smc_particles_per_s", lambda: smc_throughput(g)),
        ("vi_steps_per_s", lambda: vi_throughput(g)),
        ("vi_lifted_steps_per_s", vi_lifted_throughput),
        ("hmc_nonquad_robot_samples_per_s", hmc_robot_throughput),
        ("nuts_nonquad_robot_samples_per_s", nuts_robot_throughput),
        ("hmc_sparse_grid128_samples_per_s", hmc_sparse_grid_throughput),
        ("pod_gibbs_chain_samples_per_s", pod_gibbs_throughput),
        # scale sweep of the 1M-latent path (LAST: the longest compiles)
        ("pod600_gibbs_chain_samples_per_s",
         lambda: pod_gibbs_throughput(n_people=600, n_chains=16, chunk=1)),
        ("pod1000_gibbs_chain_samples_per_s",
         lambda: pod_gibbs_throughput(n_people=1000, n_chains=8, chunk=1)),
    ):
        v = cell(name, fn)
        out[name] = None if v is None else round(v, 1)
    # sentinel again at the END: a start/end disagreement means the
    # machine state CHANGED mid-run, flagging which metrics are suspect
    end = cell("calib_matmul_ms_end", calib_matmul_ms)
    out["calib_matmul_ms_end"] = None if end is None else round(end, 2)
    out["rep_spread"] = spreads
    print(json.dumps(out))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
