"""Checkpoint-in-the-loop sampling: chunked HMC/NUTS with resume.

SURVEY.md §6 "checkpoint-restart is the recovery story … needed for pod
runs" (the reference has no checkpointing at all). ``sample_checkpointed``
runs warmup once, then samples in chunks of ``chunk_size`` transitions,
persisting (sampler state, streamed moment sums, RNG bookkeeping) through
``utils.checkpoint.CheckpointManager`` (orbax) after every chunk. A killed
run re-invoked with the same arguments restores the latest chunk and
continues; per-chunk keys are derived by ``fold_in(key, chunk_index)``, so
an interrupted+resumed run produces BITWISE-identical moments to an
uninterrupted one.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from lhvi_tpu.fg.compile import CompiledFG
from lhvi_tpu.engines import hmc as _hmc
from lhvi_tpu.engines import nuts as _nuts


def _to_host(v):
    """Materialize a (possibly process-spanning) array on every host.

    Multi-host design choice: checkpoints
    are GATHER-THEN-SAVE — the sharded chain state is all-gathered to
    every process (one [C, n] array; chain state is small relative to the
    model tables), orbax then coordinates the actual write across
    processes as usual. Restore is read-then-reshard: every process reads
    the same payload and ``device_put(x, shard)`` lays out its local
    shards. This keeps checkpoints mesh-shape-portable (a run can resume
    on a different device count) at the cost of one DCN all-gather per
    chunk — the right trade at chain-state sizes; flip to per-process
    orbax sharding if chain state ever rivals model-table memory.
    """
    if isinstance(v, jax.Array) and not v.is_fully_addressable:
        if v.sharding.is_fully_replicated:
            return np.asarray(v.addressable_data(0))
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(v, tiled=True))
    return jax.device_get(v)


def _payload_to_host(state, sums, chunks_done: int, n_chains: int,
                     warmup_done: int):
    # orbax refuses zero-size arrays (e.g. inv_mass on n_cont==0 models):
    # omit them on save; restore rebuilds them from the shape template.
    sd = {k: _to_host(v) for k, v in state._asdict().items() if v.size}
    return {
        "state": sd,
        "sums": {str(i): _to_host(v) for i, v in enumerate(sums) if v.size},
        "chunks_done": chunks_done,
        "n_chains": n_chains,
        "warmup_done": warmup_done,
        # payload schema version — bump whenever the accumulator LAYOUT
        # changes (a positional re-interpretation would be silently wrong;
        # fmt 3 = 9-array _StreamDiag incl. the batch-means block, plus
        # the 4-array _StreamDiagDisc discrete-value split-R̂ stream;
        # fmt 4 = HMCState grew the mode-swap acceptance scalars
        # ms_acc_sum/ms_acc_n)
        "fmt": 4,
    }


def sample_checkpointed(
    fg: CompiledFG,
    key,
    cfg=None,
    *,
    engine: str = "hmc",
    n_chains: int = 8,
    n_warmup: int = 500,
    n_samples: int = 1000,
    chunk_size: int = 100,
    ckpt_dir: str,
    shard=None,
    max_to_keep: int = 3,
    disc_diag_cap: int = 4096,
    _interrupt_after: Optional[int] = None,
    _interrupt_warmup_after: Optional[int] = None,
):
    """Run (or resume) a chunked sampling job; returns ``HMCMoments``.

    Warmup is chunk-dispatched and checkpointed exactly like sampling:
    no single device execution exceeds ``chunk_size`` transitions, and a
    run preempted mid-warmup resumes from its last warmup chunk.

    ``_interrupt_after=k`` stops after persisting sample chunk k (returns
    None); ``_interrupt_warmup_after=k`` stops after persisting warmup
    chunk k — the fault-injection hooks the resume tests use to simulate
    preemption.

    ``disc_diag_cap`` bounds the streamed discrete-value split-R̂
    selection exactly as in ``hmc.run_hmc`` (its accumulators ride the
    checkpoint payload, so ``rhat_disc`` covers ALL draws of a
    preempted+resumed run too).
    """
    from lhvi_tpu.utils.checkpoint import CheckpointManager

    if engine == "hmc":
        cfg = cfg or _hmc.HMCConfig()
        fg, cfg = _hmc._ensure_mode_swap_plan(fg, cfg)
        if shard is not None:
            # quad leapfrog dispatches per shard (same rule as run_hmc)
            cfg = cfg.replace(shard=shard)
        hcfg = cfg

        def trans(state, k):
            state, acc = _hmc.hmc_transition(fg, cfg, state, k, False)
            return state, jnp.mean(acc)

    elif engine == "nuts":
        cfg = cfg or _nuts.NUTSConfig()
        fg, cfg = _hmc._ensure_mode_swap_plan(fg, cfg)
        hcfg = cfg.to_hmc()

        def trans(state, k):
            state, (acc, _, _) = _nuts.nuts_transition(fg, cfg, state, k,
                                                       False)
            return state, jnp.mean(acc)

    else:
        raise ValueError(f"unknown engine {engine!r} (hmc|nuts)")

    n_chunks = math.ceil(n_samples / chunk_size)
    half = n_samples // 2  # split point for the streamed split-R̂
    bm_len, n_batches = _hmc._bm_schedule(n_samples)
    # streamed discrete-value split-R̂ selection (host-side, static)
    sel = (_hmc.disc_diag_select(fg, disc_diag_cap)
           if fg.n_disc and disc_diag_cap > 0 else np.zeros(0, np.int32))
    n_sel = int(sel.size)
    k_init, k_warm, k_samp = jax.random.split(key, 3)

    def chunk_body(state, s1, s2, cnt, acc_sum, sd, sdd, ckey, t0, n: int):
        def step(carry, inp):
            k, t = inp
            state, s1, s2, cnt, acc_sum, sd, sdd = carry
            state, acc = trans(state, k)
            s1 = s1 + jnp.sum(state.xc, axis=0)
            s2 = s2 + jnp.sum(state.xc * state.xc, axis=0)
            if fg.n_disc:
                oh = jax.nn.one_hot(state.xd, fg.max_v, dtype=jnp.float32)
                cnt = cnt + jnp.sum(oh, axis=0)
            sd = _hmc._stream_diag_update(sd, t, state.xc, half,
                                          bm_len, n_batches)
            if n_sel:
                sdd = _hmc._stream_diag_disc_update(
                    sdd, t, _hmc._disc_sel_values(fg, sel, state.xd), half)
            return (state, s1, s2, cnt, acc_sum + acc, sd, sdd), None

        keys = jax.random.split(ckey, n)
        ts = t0 + jnp.arange(n, dtype=jnp.int32)
        (state, s1, s2, cnt, acc_sum, sd, sdd), _ = jax.lax.scan(
            step, (state, s1, s2, cnt, acc_sum, sd, sdd), (keys, ts)
        )
        return state, s1, s2, cnt, acc_sum, sd, sdd

    chunk_jit = jax.jit(chunk_body, static_argnums=9)

    def trans_adapt(s, k):
        if engine == "hmc":
            return _hmc.hmc_transition(fg, cfg, s, k, True)
        s2, (acc, _, _) = _nuts.nuts_transition(fg, cfg, s, k, True)
        return s2, acc

    def warm_chunk(state, keys):
        def step(s, k):
            s, _ = trans_adapt(s, k)
            return s, None
        state, _ = jax.lax.scan(step, state, keys)
        return state

    warm_chunk_jit = jax.jit(warm_chunk)

    def fresh_sums():
        return (
            jnp.zeros(fg.n_cont),
            jnp.zeros(fg.n_cont),
            jnp.zeros((max(fg.n_disc, 1), fg.max_v)),
            jnp.zeros(()),
            # streamed split-R̂/ESS accumulators (9 × [C, n_cont] incl.
            # the batch-means block, then 4 × [C, n_sel] for the
            # discrete-value stream — the fmt-3 part of the layout) ride the
            # checkpoint payload, so convergence evidence survives
            # preemption too
            *_hmc._stream_diag_init(n_chains, fg.n_cont),
            *_hmc._stream_diag_disc_init(n_chains, n_sel),
        )

    mgr = CheckpointManager(ckpt_dir, max_to_keep=max_to_keep)
    latest = mgr.latest_step()
    if latest is None:
        state = jax.jit(
            lambda k: _hmc.init_hmc_state(fg, k, hcfg, n_chains, shard)
        )(k_init)
        sums = fresh_sums()
        warmup_done = 0
        chunks_done = 0
        next_step = 0
    else:
        payload = mgr.restore(latest)
        if payload["n_chains"] != n_chains:
            raise ValueError(
                f"checkpoint has n_chains={payload['n_chains']}, "
                f"requested {n_chains}"
            )
        if payload.get("fmt") != 4:
            raise ValueError(
                f"checkpoint at {ckpt_dir!r} has payload format "
                f"{payload.get('fmt')!r} (expected 4): it was written by "
                "an incompatible lhvi_tpu version. Finalize it with the "
                "version that wrote it, or restart the run."
            )
        tmpl = jax.eval_shape(
            lambda k: _hmc.init_hmc_state(fg, k, hcfg, n_chains), k_init
        )
        saved = payload["state"]

        def _restore(name, saved_map, shape, dtype=None):
            # zero-SIZE entries are legitimately omitted on save (orbax
            # refuses them); a missing non-empty entry means the
            # checkpoint was written by an incompatible code version —
            # zero-filling it would finalize confidently-wrong moments
            # or R̂, so fail loudly instead.
            if name in saved_map:
                return jnp.asarray(saved_map[name])
            if int(np.prod(shape)) == 0:
                return jnp.zeros(shape, dtype)
            raise ValueError(
                f"checkpoint at {ckpt_dir!r} lacks accumulator {name!r} "
                f"(shape {shape}): it was written by an incompatible "
                "lhvi_tpu version. Finalize it with the version that "
                "wrote it, or restart the run."
            )

        state = _hmc.HMCState(**{
            k: _restore(k, saved, t.shape, t.dtype)
            for k, t in tmpl._asdict().items()
        })
        if shard is not None:
            state = state._replace(
                xc=jax.device_put(state.xc, shard),
                xd=jax.device_put(state.xd, shard),
            )
        sum_shapes = (
            (fg.n_cont,), (fg.n_cont,), (max(fg.n_disc, 1), fg.max_v), (),
        ) + ((n_chains, fg.n_cont),) * 9 + ((n_chains, n_sel),) * 4
        sums = tuple(
            _restore(str(i), payload["sums"], sh)
            for i, sh in enumerate(sum_shapes)
        )
        chunks_done = int(payload["chunks_done"])
        # pre-warmup-chunking checkpoints only exist post-warmup
        warmup_done = int(payload.get("warmup_done", n_warmup))
        next_step = latest + 1

    # --- warmup, chunk-dispatched + checkpointed --------------------------
    # Same two-phase structure (and the same key derivation) as
    # hmc.run_warmup: phase 1 = first half of the transitions, then a mass
    # refresh + dual-averaging reset, phase 2 = the rest, then a final
    # refresh and eps̄ freeze. Keys are pre-split per phase and SLICED per
    # chunk, so an interrupted+resumed warmup is bitwise-identical to an
    # uninterrupted one.
    half_w = max(n_warmup // 2, 1) if n_warmup > 0 else 0
    w_chunks_saved = 0
    while warmup_done < n_warmup:
        if warmup_done < half_w:
            pos, pend = warmup_done, half_w
            pkeys = jax.random.split(k_warm, half_w)
        else:
            pos, pend = warmup_done - half_w, n_warmup - half_w
            pkeys = jax.random.split(jax.random.fold_in(k_warm, 1),
                                     n_warmup - half_w)
        n = min(chunk_size, pend - pos)
        state = warm_chunk_jit(state, pkeys[pos:pos + n])
        warmup_done += n
        if warmup_done == half_w:
            state = _hmc._mass_refresh(fg, hcfg, state)
            state = state._replace(
                h_bar=jnp.zeros(()), t=jnp.zeros(()),
                welford_mean=jnp.zeros(fg.n_cont),
                welford_m2=jnp.zeros(fg.n_cont),
                welford_n=jnp.zeros(()),
            )
        if warmup_done == n_warmup:
            state = _hmc._mass_refresh(fg, hcfg, state)
            # sampling-window-only mode-swap acceptance, same rule as
            # run_hmc/run_nuts (this branch runs exactly once per job,
            # also on a resume-from-mid-warmup — bitwise property holds)
            state = state._replace(log_eps=state.log_eps_bar,
                                   ms_acc_sum=jnp.zeros(()),
                                   ms_acc_n=jnp.zeros(()))
        mgr.save(next_step,
                 _payload_to_host(state, sums, 0, n_chains, warmup_done),
                 wait=True)
        next_step += 1
        w_chunks_saved += 1
        if (_interrupt_warmup_after is not None
                and w_chunks_saved >= _interrupt_warmup_after):
            mgr.close()
            return None
    if n_warmup == 0 and latest is None:
        mgr.save(next_step, _payload_to_host(state, sums, 0, n_chains, 0),
                 wait=True)
        next_step += 1

    for c in range(chunks_done, n_chunks):
        n = min(chunk_size, n_samples - c * chunk_size)
        ckey = jax.random.fold_in(k_samp, c)
        t0 = jnp.asarray(c * chunk_size, jnp.int32)
        out = chunk_jit(state, *sums[:4], _hmc._StreamDiag(*sums[4:13]),
                        _hmc._StreamDiagDisc(*sums[13:]), ckey, t0, n)
        state = out[0]
        sums = tuple(out[1:5]) + tuple(out[5]) + tuple(out[6])
        mgr.save(next_step,
                 _payload_to_host(state, sums, c + 1, n_chains, n_warmup),
                 wait=True)
        next_step += 1
        if _interrupt_after is not None and (c + 1) >= _interrupt_after:
            mgr.close()
            return None
    mgr.close()

    s1, s2, cnt, acc_sum = sums[:4]
    sd = _hmc._StreamDiag(*sums[4:13])
    sdd = _hmc._StreamDiagDisc(*sums[13:])
    n_obs = n_samples * n_chains
    mean = s1 / n_obs
    var = jnp.maximum(s2 / n_obs - mean**2, 0.0)
    moments = {
        "mean": mean,
        "var": var,
        "disc_probs": cnt / n_obs,
        "n_obs": n_obs,
    }
    diag = {
        "accept_rate": acc_sum / n_samples,
        "step_size": jnp.exp(state.log_eps),
        "inv_mass": state.inv_mass,
        **({"mode_swap_accept":
            state.ms_acc_sum / jnp.maximum(state.ms_acc_n, 1.0)}
           if getattr(cfg, "mode_swap", False) else {}),
        **_hmc._stream_diag_finalize(sd, n_samples, bm_len),
        **(_hmc._stream_diag_disc_finalize(sdd, n_samples)
           if n_sel else {}),
    }
    if n_sel:
        diag["disc_diag_idx"] = jnp.asarray(sel)
    return _hmc.HMCMoments(fg, moments, diag)
