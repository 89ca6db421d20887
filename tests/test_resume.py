"""Checkpoint-in-the-loop + resume:
a killed chunked run resumed with the same key produces BITWISE-identical
streamed moments to an uninterrupted run."""

import numpy as np
import jax

from lhvi_tpu import compile_graph
from lhvi_tpu.engines import hmc
from lhvi_tpu.engines.resumable import sample_checkpointed
from lhvi_tpu.models.toy import hybrid_chain
from lhvi_tpu.utils.oracle import ExactPosterior


def test_resume_bitwise_identical(tmp_path):
    g, (d, x1, x2) = hybrid_chain()
    fg = compile_graph(g)
    key = jax.random.PRNGKey(7)
    kw = dict(engine="hmc", n_chains=16, n_warmup=100, n_samples=250,
              chunk_size=100)

    full = sample_checkpointed(fg, key, ckpt_dir=str(tmp_path / "full"), **kw)

    # interrupted after chunk 1 of 3, then resumed
    out = sample_checkpointed(fg, key, ckpt_dir=str(tmp_path / "part"),
                              _interrupt_after=1, **kw)
    assert out is None
    resumed = sample_checkpointed(fg, key, ckpt_dir=str(tmp_path / "part"),
                                  **kw)

    for k in ("mean", "var", "disc_probs"):
        assert np.array_equal(full.moments[k], resumed.moments[k]), k
    assert np.array_equal(full.diag["accept_rate"],
                          resumed.diag["accept_rate"])
    # streamed convergence accumulators survive the preemption bitwise too
    assert np.array_equal(full.diag["rhat"], resumed.diag["rhat"])
    assert np.isfinite(resumed.diag["rhat"]).all()
    assert np.array_equal(full.diag["ess_proxy"], resumed.diag["ess_proxy"])
    assert np.array_equal(full.diag["ess_bm"], resumed.diag["ess_bm"])
    assert np.isfinite(resumed.diag["ess_bm"]).all()
    # ...including the discrete-value split-R̂ stream (fmt-4 payload)
    assert np.array_equal(full.diag["rhat_disc"], resumed.diag["rhat_disc"])
    assert resumed.diag["rhat_disc"].shape == (fg.n_disc,)
    assert np.isfinite(resumed.diag["rhat_disc"]).all()

    # and the answers are actually right
    exact = ExactPosterior(g, cont_grid=161)
    assert abs(resumed.mean(x1) - exact.mean(x1)) < 0.12
    assert np.abs(resumed.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.08


def test_resume_mid_warmup_bitwise_identical(tmp_path):
    """Warmup is chunk-dispatched + checkpointed too (no single device
    execution exceeds chunk_size transitions); preemption DURING warmup
    resumes bitwise-identically."""
    g, (d, x1, x2) = hybrid_chain()
    fg = compile_graph(g)
    key = jax.random.PRNGKey(9)
    # chunk_size=40 over n_warmup=100: warmup = chunks of 40+10 | 40+10
    # (phase boundary at 50), so interrupting after 2 warmup chunks lands
    # exactly ON the phase-1 mass refresh — the trickiest resume point
    kw = dict(engine="hmc", n_chains=16, n_warmup=100, n_samples=80,
              chunk_size=40)

    full = sample_checkpointed(fg, key, ckpt_dir=str(tmp_path / "full"), **kw)

    out = sample_checkpointed(fg, key, ckpt_dir=str(tmp_path / "part"),
                              _interrupt_warmup_after=2, **kw)
    assert out is None
    resumed = sample_checkpointed(fg, key, ckpt_dir=str(tmp_path / "part"),
                                  **kw)

    for k in ("mean", "var", "disc_probs"):
        assert np.array_equal(full.moments[k], resumed.moments[k]), k
    assert np.array_equal(full.diag["accept_rate"],
                          resumed.diag["accept_rate"])


def test_resume_rejects_incompatible_checkpoint(tmp_path):
    """A checkpoint missing a non-empty accumulator (older code version)
    fails loudly instead of zero-filling into confidently wrong R̂."""
    import pytest

    from lhvi_tpu.utils.checkpoint import CheckpointManager

    g, _ = hybrid_chain()
    fg = compile_graph(g)
    key = jax.random.PRNGKey(10)
    kw = dict(engine="hmc", n_chains=8, n_warmup=20, n_samples=60,
              chunk_size=30)
    ckpt = str(tmp_path / "old")
    out = sample_checkpointed(fg, key, ckpt_dir=ckpt, _interrupt_after=1,
                              **kw)
    assert out is None

    # simulate a payload written by a pre-streamed-diagnostics version:
    # strip the _StreamDiag accumulators (keys 4..9) from the latest step
    mgr = CheckpointManager(ckpt)
    step = mgr.latest_step()
    payload = mgr.restore(step)
    payload["sums"] = {k: v for k, v in payload["sums"].items()
                       if int(k) < 4}
    mgr.save(step + 1, payload, wait=True)
    mgr.close()

    with pytest.raises(ValueError, match="incompatible"):
        sample_checkpointed(fg, key, ckpt_dir=ckpt, **kw)


def test_resume_nuts_runs(tmp_path):
    g, (d, x1, x2) = hybrid_chain()
    fg = compile_graph(g)
    res = sample_checkpointed(
        fg, jax.random.PRNGKey(8), engine="nuts", n_chains=16, n_warmup=150,
        n_samples=200, chunk_size=80, ckpt_dir=str(tmp_path / "n"),
    )
    exact = ExactPosterior(g, cont_grid=161)
    assert abs(res.mean(x1) - exact.mean(x1)) < 0.12
    assert abs(res.mean(x2) - exact.mean(x2)) < 0.12
