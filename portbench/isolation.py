"""The port runs without JAX.

A run may not load `jax`, `jaxlib`, `flax` or the JAX package
(`arttts_tpu`). Modules are compared by their top-level name, the part
before the first dot, whole: the port's own name (`arttts_tpu_torch`)
begins with the JAX package's, so a prefix test would be wrong.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "arttts_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] | None = None,
                     forbidden: frozenset = FORBIDDEN) -> List[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in list(names) if top_level(n) in forbidden)
