"""Process set-up shared by ``chip_smoke.py`` and ``bench.py``.

* The compile cache: where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
  keeps its cache there and this module sets nothing; otherwise the
  cache lives at one fixed path inside the checkout (the path is part
  of the cache's key, so a directory that moved would never hit).
* The card: its name and power limit, read once from ``nvidia-smi`` in a
  child process that never imports JAX.
* The device check: a measurement path that finds no GPU fails.
"""

from __future__ import annotations

import os
import subprocess

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
CACHE_SUBDIR = ".jax_cache"


def compile_cache_dir(environ, root) -> str | None:
    """The cache directory this program must set, or ``None`` when
    ``environ`` already names one."""
    if environ.get(CACHE_ENV):
        return None
    return os.path.join(os.fspath(root), CACHE_SUBDIR)


def configure_compile_cache(root) -> str | None:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    (before the first compilation); returns the path set, if any."""
    import jax

    path = compile_cache_dir(os.environ, root)
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_info() -> list[str]:
    """``name, power.limit`` of every card, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=120)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def require_gpu(devices, count: int = 1):
    """Raise unless ``devices`` holds at least ``count`` GPUs."""
    gpus = [d for d in devices if d.platform == "gpu"]
    if not devices or devices[0].platform != "gpu" or len(gpus) < count:
        raise RuntimeError(
            f"need {count} GPU device(s), JAX sees {list(devices)}")
    return gpus[:count]
