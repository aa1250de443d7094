"""The persistent compile cache's entry point (port of
``or_gym_inventory_tpu/utils/compile_cache.py``).

The JAX package points XLA at an on-disk cache here, so that the benchmark
scripts' large programs compile once. The port compiles no XLA program and
uses no ``torch.compile``: its only compiled artefacts are the nvcc builds,
which ``ops/_build.py`` keeps in its own ``build/`` directory. So
``enable_persistent_compile_cache`` keeps JAX's contract (the directory,
``OGT_COMPILE_CACHE`` overriding it and ``""`` disabling it, idempotent)
and does nothing more than create the directory: nothing reads it, and
nothing in the port calls it (``bench.runner.run_benchmark``, which calls
it in the JAX package, does not).
"""

from __future__ import annotations

import os
import tempfile


def enable_persistent_compile_cache(path: str = None) -> str:
    """Create the cache directory and return it; ``OGT_COMPILE_CACHE``
    overrides ``path`` and an empty one disables the cache (returns "").
    The default lies under the temporary directory."""
    env = os.environ.get("OGT_COMPILE_CACHE")
    if env == "":
        return ""
    path = env or path or os.path.join(tempfile.gettempdir(), "ogt_torch_cache")
    os.makedirs(path, exist_ok=True)
    return path
