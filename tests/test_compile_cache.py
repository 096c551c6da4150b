"""The persistent compile cache has one home: JAX_COMPILATION_CACHE_DIR
when the environment sets it, else <repo>/.jax_cache."""

import pathlib
import subprocess

import jax
import pytest

from tpurag.utils import compile_cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_environment_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == tmp_path / "c"


def test_repo_cache_without_environment(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == ROOT / ".jax_cache"


@pytest.mark.parametrize("from_env", [True, False])
def test_enable_sets_only_the_cache_dir(monkeypatch, tmp_path, from_env):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(compile_cache, "REPO_CACHE", tmp_path / "repo")
    path = compile_cache.enable_compile_cache()
    assert path.is_dir()
    assert calls == [("jax_compilation_cache_dir", str(path))]
    assert path == (tmp_path / ("c" if from_env else "repo"))


def test_no_other_code_sets_a_cache():
    files = subprocess.run(
        ["git", "grep", "-l", "jax_compilation_cache_dir", "--", "*.py"],
        cwd=ROOT, capture_output=True, text=True).stdout.split()
    assert set(files) <= {"tpurag/utils/compile_cache.py",
                          "tests/test_compile_cache.py"}
