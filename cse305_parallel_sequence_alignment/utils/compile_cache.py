"""Persistent XLA compilation cache placement.

The cache lives in ``JAX_COMPILATION_CACHE_DIR`` when that is set, and
otherwise in ``<checkout>/.jax_cache/`` (listed in .gitignore): one fixed
directory, so every entry point of a checkout (CLI, bench.py,
chip_smoke.py) pays each program's compile once. CPU runs (the tests)
keep no cache: reloading AOT CPU executables across toolchain updates
warns about machine-feature mismatches.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT_CACHE = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_persistent_cache():
    """Point jax's persistent compilation cache at its directory."""
    if "cpu" in os.environ.get("JAX_PLATFORMS", ""):
        return
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
        str(CHECKOUT_CACHE)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.4)
