"""The compile-cache helper (curvis_tpu/utils/cache.py): it sets nothing
when JAX_COMPILATION_CACHE_DIR is set, and otherwise places the cache at
the fixed <checkout>/.jax_cache."""
import jax

from curvis_tpu.utils import cache


def _capture(monkeypatch):
    seen = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: seen.append((name, value)))
    return seen


def test_env_variable_set_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    seen = _capture(monkeypatch)
    assert cache.enable_compile_cache() == str(tmp_path)
    assert seen == []


def test_env_variable_unset_uses_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    seen = _capture(monkeypatch)
    path = cache.enable_compile_cache()
    assert path == str(cache.CHECKOUT / ".jax_cache")
    assert seen == [("jax_compilation_cache_dir", path)]
    assert (cache.CHECKOUT / "curvis_tpu").is_dir()
    assert ".jax_cache/" in (cache.CHECKOUT / ".gitignore").read_text()
