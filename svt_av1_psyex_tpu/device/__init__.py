"""Device (XLA) compute plane of the encoder.

Everything here is batched over all blocks/superblocks of a frame and
jit-compiled; the host keeps only the sequential, context-exact work
(argmin tree walks, conformant commit, entropy coding). This is the
SURVEY §7 split: device = candidate cost evaluation, host = selection.
"""

from pathlib import Path

# Fixed, gitignored cache directory inside the checkout. The path is part
# of what a later process must find, so it never depends on a temp name,
# a PID or the time.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Arm JAX's persistent compilation cache and return its directory.

    A directory JAX already has (JAX_COMPILATION_CACHE_DIR, or
    `jax_compilation_cache_dir` set by the caller) is left as it is;
    otherwise the cache goes to DEFAULT_CACHE_DIR. JAX decides at the
    first compile of a process whether it uses a cache, so call this
    before anything is jitted."""
    import jax

    cur = jax.config.jax_compilation_cache_dir
    if cur:
        return cur
    DEFAULT_CACHE_DIR.mkdir(exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
