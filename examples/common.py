"""Shared runner for the example/experiment scripts.

Mirrors the reference's demo-script role (SURVEY.md §3.1 "Experiments"):
build model → run engine(s) → query marginals → compare + report. One
``run_engine`` entry drives any backend from an ``EngineConfig``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def setup_platform(force_cpu: bool = False, n_virtual: int = 8):
    """Pick the platform and turn on the compile cache.

    ``force_cpu`` runs on an ``n_virtual``-device CPU mesh; otherwise the
    examples need a GPU and stop if JAX finds none."""
    import jax

    if force_cpu:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={n_virtual}"
            ).strip()
        jax.config.update("jax_platforms", "cpu")
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit("no GPU found; pass --cpu to run on the CPU mesh")
    from lhvi_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    return jax


def run_engine(fg, cfg, key):
    """Dispatch an EngineConfig to the matching backend; returns a result
    object exposing mean/var/disc_marginal/map plus ('wall_s', seconds)."""
    import jax

    from lhvi_tpu.engines import hmc, nuts, smc, vi
    from lhvi_tpu.engines.epbp import EPBP, EPBPConfig
    from lhvi_tpu.engines.lbp import HybridLBP
    from lhvi_tpu.engines.map_search import HybridMaxWalkSAT

    t0 = time.perf_counter()
    e = cfg.engine
    if e in ("nuts", "hmc"):
        mod = nuts if e == "nuts" else hmc
        kw = dict(
            n_chains=cfg.n_chains, n_warmup=cfg.n_warmup,
            n_samples=cfg.n_samples, collect=cfg.collect,
        )
        res = mod.sample(fg, key, **kw)
    elif e == "vi":
        res = vi.infer(
            fg, key, vi.VIConfig(K=cfg.vi_k, n_iters=cfg.vi_iters, lr=cfg.vi_lr)
        )
    elif e == "smc":
        res = smc.sample(
            fg, key,
            smc.SMCConfig(
                n_particles=cfg.smc_particles, n_temps=cfg.smc_temps,
                adaptive=getattr(cfg, "smc_adaptive", False),
            ),
        )
    elif e == "lbp":
        res = HybridLBP(fg).run(cfg.bp_iters)
    elif e == "epbp":
        res = EPBP(fg, EPBPConfig(cfg.particles, cfg.bp_iters)).run(key)
    elif e == "mws":
        res = HybridMaxWalkSAT(fg).run(key)
    else:
        raise ValueError(f"unknown engine {e!r}")
    res.wall_s = time.perf_counter() - t0
    return res


def make_parser(cfg, desc: str) -> argparse.ArgumentParser:
    from lhvi_tpu.config import add_args

    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--cpu", action="store_true",
                   help="force the virtual CPU mesh")
    add_args(p, cfg)
    return p
