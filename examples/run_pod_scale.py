"""BASELINE config 5: pod-scale lifted MRF (~1e5 grounded variables).

Demonstrates the production path end-to-end:
  1. ground a ~1e5-variable hybrid relational model (partial evidence
     breaks full exchangeability);
  2. native C++ color refinement → lifted VI (orbit-tied params);
  3. grounded HMC-within-Gibbs with the chains axis sharded over the
     device mesh, streaming moments (no sample materialization),
     checkpointing, and JSONL metrics;
  4. a scaling harness: samples/s on 1 device vs the full mesh.

Multi-host: launch one process per host and pass --distributed with
--coordinator host:port, --num-processes and --process-id; the mesh then
spans hosts and the same code runs unchanged.

    python examples/run_pod_scale.py --cpu --n-people 120   # smoke test
    python examples/run_pod_scale.py --n-people 320         # one GPU
    python examples/run_pod_scale.py --n-people 1000 --fast --n-chains 8
                                      # 1,001,900 grounded latents
"""

import time

import numpy as np

from common import make_parser, setup_platform
from lhvi_tpu.config import PodConfig, from_args


def main():
    parser = make_parser(PodConfig(), __doc__)
    parser.add_argument("--distributed", action="store_true",
                        help="call jax.distributed.initialize() first")
    parser.add_argument("--coordinator", default="localhost:29500",
                        help="with --distributed: coordinator host:port")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("--chunk", type=int, default=4,
                        help="samples per device dispatch. chunk=1 pays "
                        "one dispatch round-trip per sample AND yields "
                        "NaN streamed R-hat (the split needs >=4 "
                        "draws/dispatch)")
    parser.add_argument("--mode-swap", type=lambda s: s.lower() in
                        ("1", "true", "yes"), default=True,
                        help="collapsed orbit-flip MH move after each "
                        "Gibbs sweep (engines/modeswap.py) — the "
                        "production default: without it the "
                        "ferromagnetic smokes clique freezes per chain "
                        "and rhat_disc saturates (discrete mode-locking)")
    parser.add_argument("--mode-swap-every", type=int, default=1,
                        help="apply the mode-swap move with probability "
                        "1/k per transition (random-scan mixture, still "
                        "exact) — amortizes its two conditional-logit "
                        "passes behind a lax.cond")
    parser.add_argument("--fast", action="store_true",
                        help="ground via the vectorized relational→IR "
                        "compiler (relational/fast.py) — no per-ground "
                        "Python objects; lifted VI runs on the IR-level "
                        "orbit refinement (lift/fast.py). Required in "
                        "practice beyond ~3e5 groundings.")
    args = parser.parse_args()
    cfg = from_args(PodConfig, args)
    jax = setup_platform(args.cpu)
    if args.distributed:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes, process_id=args.process_id)

    from lhvi_tpu import compile_graph
    from lhvi_tpu.engines import hmc, vi
    from lhvi_tpu.lift import compile_lifted, lifting_report
    from lhvi_tpu.models.relational import friends_smokers
    from lhvi_tpu.parallel import chain_sharding, make_mesh
    from lhvi_tpu.utils.metrics import MetricsLogger

    log = MetricsLogger(cfg.metrics_path, echo=True)

    # ---- 1. ground --------------------------------------------------------
    t0 = time.perf_counter()
    rg = friends_smokers(n_people=cfg.n_people, hybrid=True)
    for i in range(cfg.evidence_people):
        rg.observe("smokes", (f"p{i}",), i % 2)

    vi_params_host = None
    if args.fast:
        # vectorized relational→IR path: templates ground straight to
        # array buckets; engines are queried by (pred, consts) keys
        from lhvi_tpu.relational.fast import fast_compile

        fg = fast_compile(rg)
        from lhvi_tpu.fg.compile import color_plan_bytes

        log.log("fast_compile", wall_s=round(time.perf_counter() - t0, 2),
                n_cont=fg.n_cont, n_disc=fg.n_disc,
                # replicated per device at any mesh size
                plan_mb=round(color_plan_bytes(fg)["total_bytes"] / 1e6, 1))

        # ---- 2. lifted VI on the IR-level orbits ---------------------------
        from lhvi_tpu.lift.fast import fast_lift

        t0 = time.perf_counter()
        fg_l = fast_lift(fg)
        log.log("fast_lift", n_rv_orbits=fg_l.n_cont + fg_l.n_disc,
                n_factor_orbits=int(sum(
                    (b["scale"] > 0).sum() for b in fg_l.meta.np_buckets)),
                wall_s=round(time.perf_counter() - t0, 2))

        t0 = time.perf_counter()
        res_vi = vi.infer(
            fg_l, jax.random.PRNGKey(cfg.seed),
            vi.VIConfig(K=cfg.vi_k, n_iters=cfg.vi_iters, lr=cfg.vi_lr),
        )
        log.log("lifted_vi", elbo=float(res_vi.trace[-1]),
                wall_s=round(time.perf_counter() - t0, 2))
        # queries by (pred, consts) key resolve through the orbit map
        for who in ("p1", "p0"):
            log.log("query", rv=f"cancer({who})",
                    marginal=res_vi.disc_marginal(
                        ("cancer", (who,))).round(4))
        vi_params_host = res_vi.params
        del res_vi, fg_l
        jax.clear_caches()
    else:
        g, index = rg.ground()
        log.log("ground", n_rvs=len(g.rvs), n_factors=len(g.factors),
                wall_s=round(time.perf_counter() - t0, 2))

        # ---- 2. lifted VI -------------------------------------------------
        t0 = time.perf_counter()
        rep = lifting_report(g)
        fg_l = compile_lifted(g)
        log.log("lift", **rep, wall_s=round(time.perf_counter() - t0, 2))

        t0 = time.perf_counter()
        res_vi = vi.infer(
            fg_l, jax.random.PRNGKey(cfg.seed),
            vi.VIConfig(K=cfg.vi_k, n_iters=cfg.vi_iters, lr=cfg.vi_lr),
        )
        log.log("lifted_vi", elbo=float(res_vi.trace[-1]),
                wall_s=round(time.perf_counter() - t0, 2))
        # p1 observes smokes=1 (evidence is i%2), so cancer(p1) ≈ σ(w) ≈ 0.77;
        # p0 observes smokes=0, leaving cancer(p0) unconstrained at 0.5
        for who in ("p1", "p0"):
            rv = index[("cancer", (who,))]
            log.log("query", rv=f"cancer({who})",
                    marginal=res_vi.disc_marginal(rv).round(4))

        # ---- 3+4. grounded sharded HMC + scaling harness -------------------
        # drop the lifted-VI executables first (device memory for the
        # 1e5-var HMC program)
        vi_params_host = res_vi.params  # already device_get'd by VIResult
        del res_vi
        jax.clear_caches()
        t0 = time.perf_counter()
        fg = compile_graph(g)
        log.log("compile_grounded", wall_s=round(time.perf_counter() - t0, 2),
                n_cont=fg.n_cont, n_disc=fg.n_disc)

    # gibbs_max_colors=0 → the compile-time per-color plan: FULL exact
    # chromatic sweeps at O(Σ deg) kernel-row cost per sweep (the legacy
    # rotated all-rows path needed gibbs_max_colors=4 to stay affordable
    # and still cost ~40x more per iteration while updating ~1% of vars)
    hcfg = hmc.HMCConfig(n_leapfrog=6, init_step_size=0.1,
                         mode_swap=args.mode_swap,
                         mode_swap_every=args.mode_swap_every)
    if args.mode_swap:
        # build + attach the orbit plan ONCE (refine_ir costs seconds at
        # pod scale; run_hmc would otherwise hit the plan cache per call
        # — attaching it here also logs what the move will flip)
        from lhvi_tpu.engines.modeswap import plan_for

        t0 = time.perf_counter()
        plan = plan_for(fg)
        if plan is not None:
            fg = fg.replace(mode_swap_plan=plan)
            log.log("mode_swap_plan", n_groups=plan.n_groups,
                    group_width=plan.n_vars,
                    wall_s=round(time.perf_counter() - t0, 2))
        else:
            log.log("mode_swap_plan", n_groups=0)

    def measure(shard, n_chains, tag):
        # chunked dispatches: each run_hmc call is one device program of
        # `chunk` samples, looped from the host
        chunk = args.chunk
        kw = dict(n_chains=n_chains, n_warmup=0, n_samples=chunk,
                  collect="moments", shard=shard)
        # compile + first run
        jax.block_until_ready(
            hmc.run_hmc(fg, jax.random.PRNGKey(0), hcfg, **kw))
        t0 = time.perf_counter()
        n_chunks = 2
        for rep in range(n_chunks):
            out = jax.block_until_ready(
                hmc.run_hmc(fg, jax.random.PRNGKey(1 + rep), hcfg, **kw))
        dt = time.perf_counter() - t0
        sps = n_chains * chunk * n_chunks / dt
        log.log("throughput", config=tag, chains=n_chains,
                samples_per_s=round(sps, 1), wall_s=round(dt, 2))
        # streamed convergence evidence (split-R̂ needs ≥4 draws per
        # dispatch; with chunk=1 it is NaN by construction)
        diag = out[2]
        rhat = np.asarray(diag.get("rhat", np.nan))
        if np.isfinite(rhat).any():
            rhat_d = np.asarray(diag.get("rhat_disc", np.nan))
            log.log("convergence", config=tag,
                    rhat_max=round(float(np.nanmax(rhat)), 4),
                    ess_proxy_min=round(float(np.nanmin(
                        np.asarray(diag["ess_proxy"]))), 1),
                    # discrete-value split-R̂ over the color-stratified
                    # monitored subset. The max
                    # SATURATES on any var frozen at chain-specific
                    # values (W→0); the fraction above 1.1 is the
                    # interpretable mode-locking measure.
                    rhat_disc_max=(round(float(np.nanmax(rhat_d)), 4)
                                   if np.isfinite(rhat_d).any() else None),
                    rhat_disc_frac_gt_1p1=(
                        round(float(np.mean(rhat_d > 1.1)), 4)
                        if np.isfinite(rhat_d).any() else None),
                    n_disc_monitored=int(
                        np.asarray(diag.get("disc_diag_idx", [])).size),
                    accept=round(float(diag["accept_rate"]), 3))
        return sps, out

    n_dev = len(jax.devices())
    shard_full = (
        chain_sharding(make_mesh(axis_names=("dp",))) if n_dev > 1 else None
    )
    sps_full, out_full = measure(shard_full, cfg.n_chains, f"{n_dev}dev")
    if args.fast:
        # posterior queries straight from the streamed moments; fast_compile
        # grounds no RV objects, so queries are (pred, consts) keys
        probs = np.asarray(out_full[0]["disc_probs"])
        for who in ("p1", "p0"):
            kind, i = fg.meta.loc(("cancer", (who,)))
            log.log("query", rv=f"cancer({who})",
                    marginal=probs[i, :2].round(4))
    if n_dev > 1:
        mesh1 = make_mesh(shape=(1,), axis_names=("dp",),
                          devices=jax.devices()[:1])
        sps_1, _ = measure(chain_sharding(mesh1), cfg.n_chains // n_dev,
                           "1dev")
        eff = sps_full / (sps_1 * n_dev)
        log.log("scaling", devices=n_dev, efficiency=round(eff, 3))

    # ---- production run: checkpointed chunks + full-run convergence ------
    # chunked dispatches keep each device execution short, the orbax
    # payload makes the run preemption-safe, and the streamed
    # split-R̂/ESS accumulate across
    # chunks — so convergence evidence covers ALL draws, unlike the
    # per-dispatch diag of the throughput probes above (chunk=1 → NaN R̂).
    if cfg.checkpoint_dir:
        from lhvi_tpu.engines.resumable import sample_checkpointed

        t0 = time.perf_counter()
        res = sample_checkpointed(
            fg, jax.random.PRNGKey(cfg.seed + 1), cfg=hcfg, engine="hmc",
            n_chains=cfg.n_chains, n_warmup=cfg.n_warmup,
            n_samples=cfg.n_samples, chunk_size=args.chunk,
            ckpt_dir=cfg.checkpoint_dir + "/hmc", shard=shard_full,
        )
        rhat = np.asarray(res.diag["rhat"])
        ess = np.asarray(res.diag["ess_proxy"])
        rhat_d = np.asarray(res.diag.get("rhat_disc", np.nan))
        ess_bm = np.asarray(res.diag.get("ess_bm", np.nan))
        # n_samples < 4 → all-NaN R̂ (the split needs ≥2 draws per half):
        # guard finiteness, not just size, so smoke runs don't feed NaN
        # into np.nanmax / the JSONL line
        has_rhat = rhat.size and bool(np.isfinite(rhat).any())
        log.log(
            "production_run",
            n_samples=cfg.n_samples, chunk=args.chunk,
            wall_s=round(time.perf_counter() - t0, 2),
            accept=round(float(res.diag["accept_rate"]), 3),
            rhat_max=(round(float(np.nanmax(rhat)), 4) if has_rhat
                      else None),
            ess_proxy_min=(round(float(np.nanmin(ess)), 1)
                           if has_rhat and np.isfinite(ess).any()
                           else None),
            # full-run discrete convergence evidence (color-stratified
            # monitored subset; accumulators ride the orbax payload).
            # max saturates on frozen-disagreeing vars; the >1.1
            # fraction measures mode-locking
            rhat_disc_max=(round(float(np.nanmax(rhat_d)), 4)
                           if np.isfinite(rhat_d).any() else None),
            rhat_disc_frac_gt_1p1=(
                round(float(np.mean(rhat_d > 1.1)), 4)
                if np.isfinite(rhat_d).any() else None),
            n_disc_monitored=int(
                np.asarray(res.diag.get("disc_diag_idx", [])).size),
            ess_bm_min=(round(float(np.nanmin(ess_bm)), 1)
                        if np.isfinite(ess_bm).any() else None),
            mode_swap_accept=(
                round(float(res.diag["mode_swap_accept"]), 4)
                if "mode_swap_accept" in res.diag else None),
        )
        if vi_params_host is not None:
            from lhvi_tpu.utils.checkpoint import CheckpointManager

            mgr = CheckpointManager(cfg.checkpoint_dir + "/vi")
            mgr.save(0, {"vi_params": vi_params_host}, wait=True)
            log.log("checkpoint", step=0, path=cfg.checkpoint_dir)
            mgr.close()

    log.close()


if __name__ == "__main__":
    main()
