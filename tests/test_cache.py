"""Compile-cache location (``lhvi_tpu.utils.cache``) and the chip smoke
script's refusal to run without an accelerator."""

import os
import subprocess
import sys

import jax

from lhvi_tpu.utils import cache


def test_cache_follows_env_var(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_repo_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = cache.enable_compile_cache()
        assert path == os.path.join(cache.REPO_ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isfile(os.path.join(cache.REPO_ROOT, "chip_smoke.py"))
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(cache.REPO_ROOT, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=cache.REPO_ROOT,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
