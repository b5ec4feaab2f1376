"""Package-relative resource paths (counterpart of `arttts_tpu/core/paths.py`,
ref `src/paths.py:1-22`), pointing at the port's own copies: the JAX
package's other entries (artifact roots) are read by nothing the port has.
"""

from __future__ import annotations

from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent

# the CMU pronouncing dictionary, a byte-for-byte copy of the JAX package's
CMUDICT_PATH = PKG_DIR / "resources/cmu_dictionary"
