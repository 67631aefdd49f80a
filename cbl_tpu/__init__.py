"""cbl_tpu — an exact dynamic k-mer set (CBL method) on an accelerator.

A from-scratch JAX/XLA/Pallas re-design of the Conway–Bromage–Lyndon k-mer
set (reference: imartayan/CBL, Bioinformatics btae217).  The compute path —
2-bit encoding, sliding-window k-mer extraction, necklace canonicalisation,
and sorted-set maintenance — runs as batched XLA programs on the device;
multi-device scaling shards the necklace prefix space over a
`jax.sharding.Mesh`.
"""

import os as _os

import jax as _jax

# XLA compiles a program per array shape; capacities are power-of-two tiers,
# so the set of shapes is small and stable — persist them across processes.
# JAX_COMPILATION_CACHE_DIR, when set, is honoured by JAX itself.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    ))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from .config import CBLConfig, get_config
from .cbl import CBL, PackedStream

__all__ = ["CBL", "CBLConfig", "PackedStream", "get_config"]
__version__ = "0.1.0"
