"""Device platform and persistent compile cache for the entry points.

JAX picks the device itself (the GPU where its CUDA plugin finds one, the CPU
otherwise, or whatever ``JAX_PLATFORMS`` names). Nothing here retries or
falls back: an entry point reports what it runs on, and a measurement that
needs the GPU refuses to run anywhere else.
"""
from __future__ import annotations

import os
import sys

# fixed, so that every process of this checkout hits the same cache
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Use ``JAX_COMPILATION_CACHE_DIR`` as JAX reads it when it is set;
    otherwise keep the persistent compile cache at ``CACHE_DIR``. Returns
    the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return CACHE_DIR


def device_platform(require: str | None = None) -> str:
    """Enable the compile cache, print the platform JAX runs on to stderr and
    return it (``jax.devices()[0].platform``). ``require``: raise unless the
    platform is this one."""
    import jax

    enable_compile_cache()
    dev = jax.devices()[0]
    print(
        f"# platform: {dev.platform} ({dev.device_kind}, "
        f"{len(jax.devices())} device(s))",
        file=sys.stderr,
        flush=True,
    )
    if require is not None and dev.platform != require:
        raise RuntimeError(
            f"this needs a {require} device; JAX runs on {dev.platform}"
        )
    return dev.platform
