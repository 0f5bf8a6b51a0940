"""The persistent compile cache helper and the drivers' JAX set-up."""

import os

import jax

from gbp_poplar.drivers import common
from gbp_poplar.utils import compile_cache

_REPO = os.path.join(os.path.dirname(__file__), "..")


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_dir_is_fixed_and_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        first = compile_cache.enable_compile_cache()
        second = compile_cache.enable_compile_cache()
        assert first == second == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == first
        assert os.path.dirname(first) == os.path.abspath(_REPO)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_dir_is_gitignored():
    name = os.path.basename(compile_cache.DEFAULT_DIR)
    with open(os.path.join(_REPO, ".gitignore")) as f:
        patterns = {ln.strip().strip("/") for ln in f}
    assert name in patterns, f"{name} is not listed in .gitignore"


def test_compile_seconds_counts_a_new_compile(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    common.init_jax()
    t0 = common.compile_seconds()
    jax.jit(lambda x: x * 3.0 + 1.0)(jax.numpy.arange(7.0)).block_until_ready()
    assert common.compile_seconds() > t0
