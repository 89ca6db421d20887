"""Image MRF, switching LDS, evidence loader, and tp-sharding tests."""

import numpy as np
import jax
import jax.numpy as jnp

from lhvi_tpu import compile_graph
from lhvi_tpu.engines import gabp, hmc, vi
from lhvi_tpu.engines.lbp import HybridLBP
from lhvi_tpu.models.image import denoise_grid
from lhvi_tpu.models.lds import switching_lds
from lhvi_tpu.relational.data import load_evidence, parse_evidence_line


def test_image_denoise_recovers_step():
    g, rvs, truth, obs = denoise_grid(rows=8, cols=8, noise=0.25, seed=0)
    fg = compile_graph(g)
    res = hmc.sample(
        fg, jax.random.PRNGKey(0), n_chains=16, n_warmup=300,
        n_samples=500, collect="moments",
    )
    est = np.array([[res.mean(rvs[r][c]) for c in range(8)] for r in range(8)])
    # denoised estimate must beat the raw observation in MSE
    mse_est = np.mean((est - truth) ** 2)
    mse_obs = np.mean((obs - truth) ** 2)
    assert mse_est < 0.6 * mse_obs, (mse_est, mse_obs)


def test_switching_lds_builds_and_samples():
    g, xs, ss = switching_lds(T=8, seed=0)
    fg = compile_graph(g)
    res = hmc.sample(
        fg, jax.random.PRNGKey(1), n_chains=16, n_warmup=200, n_samples=300
    )
    # states should broadly track the upward-drifting observations
    assert res.mean(xs[-1]) > res.mean(xs[0])
    p = res.disc_marginal(ss[3])
    assert 0.0 <= p[0] <= 1.0 and abs(p.sum() - 1.0) < 1e-6


def test_evidence_parser():
    text = """
    # comment line
    smokes(anna) = 1
    friends(anna, bob)=1
    stress(bob) = 0.73
    !cancer(chris)
    cancer(anna)
    """
    ev = load_evidence(text)
    assert ev[("smokes", ("anna",))] == 1
    assert ev[("friends", ("anna", "bob"))] == 1
    assert abs(ev[("stress", ("bob",))] - 0.73) < 1e-9
    assert ev[("cancer", ("chris",))] == 0
    assert ev[("cancer", ("anna",))] == 1
    assert parse_evidence_line("  # only a comment") is None


def test_evidence_roundtrip_into_model():
    from lhvi_tpu.models.relational import friends_smokers

    rg = friends_smokers(n_people=3, hybrid=False)
    rg.observe_many(load_evidence("smokes(p0) = 1\n!cancer(p1)\n"))
    g, index = rg.ground()
    assert index[("smokes", ("p0",))].value == 1
    assert index[("cancer", ("p1",))].value == 0


def test_tp_sharded_elbo_matches_unsharded():
    """Factor-axis (tp) sharding: same ELBO value, collectives inserted."""
    from lhvi_tpu.models.toy import gaussian_grid
    from lhvi_tpu.parallel import make_mesh, shard_fg_factors

    assert len(jax.devices()) == 8
    mesh = make_mesh((2, 4), ("dp", "tp"))
    g, _ = gaussian_grid(5, 5, seed=0, evidence_frac=0.2)
    fg = compile_graph(g, pad_to=8, fuse_quadratic=False)
    fg_tp = shard_fg_factors(fg, mesh, "tp")

    cfg = vi.VIConfig(K=2, n_quad=5)
    params = vi.init_params(fg, jax.random.PRNGKey(0), cfg)
    e0 = float(jax.jit(lambda p: vi.elbo(fg, p, 5))(params))
    e1 = float(jax.jit(lambda p: vi.elbo(fg_tp, p, 5))(params))
    assert np.isclose(e0, e1, rtol=1e-5), (e0, e1)

    # log_prob path as well
    xc, xd = fg.init_state(jax.random.PRNGKey(1))
    l0 = float(fg.log_prob(xc, xd))
    l1 = float(fg_tp.log_prob(xc, xd))
    assert np.isclose(l0, l1, rtol=1e-5)


def test_engine_comparison_script_smoke(tmp_path):
    """The cross-engine comparison experiment (reference-paper headline
    figure) runs end-to-end and emits scored JSONL points."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "cmp.jsonl"
    r = subprocess.run(
        [sys.executable, "run_engine_comparison.py", "--cpu", "--quick",
         "--model", "chain", "--engines", "vi,lbp",
         "--metrics", str(out)],
        cwd=os.path.join(repo, "examples"),
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    pts = [json.loads(line) for line in out.read_text().splitlines()
           if '"point"' in line]
    assert {p["engine"] for p in pts} == {"vi", "lbp"}
    assert all(p["mean_err_avg"] is not None for p in pts)


def test_pod_scale_script_emits_scaling_event(tmp_path):
    """The pod-scale scaling harness runs end-to-end on
    the virtual CPU mesh and emits the `scaling` efficiency event plus
    per-config convergence events carrying the discrete split-R̂ fields."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "pod.jsonl"
    r = subprocess.run(
        [sys.executable, "run_pod_scale.py", "--cpu", "--fast",
         "--n-people", "60", "--n-chains", "16", "--chunk", "4",
         "--metrics-path", str(out)],
        cwd=os.path.join(repo, "examples"),
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    evs = [json.loads(line) for line in out.read_text().splitlines()]
    by = {}
    for e in evs:
        by.setdefault(e["event"], []).append(e)
    scal = by.get("scaling")
    assert scal and scal[0]["devices"] == 8
    assert 0.0 < scal[0]["efficiency"]
    conv = by.get("convergence")
    assert conv and all("rhat_disc_max" in c and c["n_disc_monitored"] > 0
                        for c in conv)
