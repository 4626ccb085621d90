"""enable_compile_cache: follows JAX_COMPILATION_CACHE_DIR when it is set,
else the fixed directory <repo>/.jax_cache."""

import os

import jax
import pytest

import totsu_tpu
from totsu_tpu.utils import enable_compile_cache
from totsu_tpu.utils.compile_cache import REPO_ROOT


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_cache_follows_the_environment(monkeypatch, tmp_path,
                                       restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path / "env")
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_repo_directory(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == os.path.join(REPO_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # REPO_ROOT is the directory that holds the package
    pkg_dir = os.path.dirname(os.path.abspath(totsu_tpu.__file__))
    assert os.path.dirname(pkg_dir) == REPO_ROOT
