"""Multi-host execution path: jax.distributed over two local processes.

SURVEY.md §3.2/§6 "collective comms … host-spanning over DCN": the same
`run_hmc(shard=…)` entry point must work when the mesh spans PROCESSES
(each process owning a subset of devices), which is the actual multi-host
contract (`jax.distributed.initialize` + a (dcn, dp) mesh). CI has one
host, so this spawns two local processes with 4 virtual CPU devices each
and runs the sampler over the global 8-device mesh — the same program
shape a real 2-host DCN run executes.

The worker is this file itself (`python test_multihost.py worker <pid>`).
"""

import os
import subprocess
import sys

import pytest


_PORT = 29517


def _worker(pid: int, nproc: int = 2):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{_PORT}",
        num_processes=nproc,
        process_id=pid,
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from lhvi_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import hmc
    from lhvi_tpu.models.toy import hybrid_chain

    assert jax.process_count() == nproc
    assert len(jax.devices()) == nproc * 4

    g, (d, x1, x2) = hybrid_chain()
    fg = compile_graph(g)

    devs = np.array(jax.devices()).reshape(nproc, 4)
    mesh = Mesh(devs, ("dcn", "dp"))
    shard = NamedSharding(mesh, P(("dcn", "dp")))

    moments, _, diag = hmc.run_hmc(
        fg, jax.random.PRNGKey(0), hmc.HMCConfig(),
        n_chains=32, n_warmup=200, n_samples=300,
        collect="moments", shard=shard,
    )
    # moments are chain-axis reductions -> replicated across the mesh
    mean = np.asarray(jax.device_get(moments["mean"]))
    dp = np.asarray(jax.device_get(moments["disc_probs"]))
    assert np.isfinite(mean).all()
    # hybrid_chain closed-ish forms (loose MC tolerances at 32x300)
    assert abs(dp[0, 1] - 0.7) < 0.15, dp

    # annealed SMC with the particle axis spanning both processes: the
    # systematic-resampling gather crosses the process boundary (the
    # north-star collective resampler) and log-Z comes back replicated
    from lhvi_tpu.engines import smc

    xc, xd, log_w, log_z, sdiag = smc.run_smc(
        fg, jax.random.PRNGKey(1),
        smc.SMCConfig(n_particles=2048, n_temps=25), shard=shard,
    )
    lz = float(jax.device_get(log_z))
    assert np.isfinite(lz)
    assert float(jax.device_get(jnp.min(sdiag["ess"]))) > 2048 * 0.1

    # --- checkpoint-in-the-loop ACROSS the process boundary (r3 #7) ------
    # gather-then-save / read-then-reshard (see resumable._to_host):
    # a run killed mid-stream and resumed must be bitwise-identical to an
    # uninterrupted one, with the chain axis spanning both processes.
    from lhvi_tpu.engines.resumable import sample_checkpointed

    ckroot = os.environ["LHVI_MH_CKPT"]
    kw = dict(engine="hmc", n_chains=16, n_warmup=20, n_samples=40,
              chunk_size=10, shard=shard,
              cfg=hmc.HMCConfig(n_leapfrog=4, init_step_size=0.3))
    full = sample_checkpointed(
        fg, jax.random.PRNGKey(2), ckpt_dir=ckroot + "/a", **kw)
    interrupted = sample_checkpointed(
        fg, jax.random.PRNGKey(2), ckpt_dir=ckroot + "/b",
        _interrupt_after=2, **kw)
    assert interrupted is None
    resumed = sample_checkpointed(
        fg, jax.random.PRNGKey(2), ckpt_dir=ckroot + "/b", **kw)
    assert (full.moments["mean"] == resumed.moments["mean"]).all()
    assert (full.moments["disc_probs"] == resumed.moments["disc_probs"]).all()
    assert full.diag["accept_rate"] == resumed.diag["accept_rate"]

    if pid == 0:
        print("MULTIHOST_HMC_OK", mean.round(3), dp[0].round(3),
              "SMC_LOGZ", round(lz, 3), "RESUME_BITWISE_OK")


@pytest.mark.skipif(
    os.environ.get("LHVI_SKIP_MULTIHOST") == "1",
    reason="multi-process spawn disabled",
)
def test_run_hmc_over_two_process_dcn_mesh(tmp_path):
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    # shared checkpoint root for the resume-bitwise segment (stands in for
    # the shared filesystem a real pod checkpoint setup requires)
    env["LHVI_MH_CKPT"] = str(tmp_path / "ck")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
    assert "MULTIHOST_HMC_OK" in outs[0], outs[0][-3000:]


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "worker":
        _worker(int(sys.argv[2]))
    else:
        raise SystemExit("usage: test_multihost.py worker <pid>")
