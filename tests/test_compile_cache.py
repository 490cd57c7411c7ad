"""Where the persistent compilation cache goes (utils/compile_cache.py)."""

import jax

from cse305_parallel_sequence_alignment.utils import compile_cache


def _updates(monkeypatch, env):
    for key in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    compile_cache.enable_persistent_cache()
    return calls


def test_cache_in_checkout_by_default(monkeypatch):
    calls = _updates(monkeypatch, {"JAX_PLATFORMS": "cuda"})
    want = compile_cache.CHECKOUT_CACHE
    assert calls["jax_compilation_cache_dir"] == str(want)
    assert want.name == ".jax_cache"
    assert (want.parent / "cse305_parallel_sequence_alignment").is_dir()


def test_cache_follows_the_environment(monkeypatch, tmp_path):
    calls = _updates(monkeypatch, {"JAX_COMPILATION_CACHE_DIR":
                                   str(tmp_path)})
    assert calls["jax_compilation_cache_dir"] == str(tmp_path)


def test_no_cache_on_cpu(monkeypatch):
    assert _updates(monkeypatch, {"JAX_PLATFORMS": "cpu"}) == {}
