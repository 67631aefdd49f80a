"""Static configuration for a CBL index.

The reference derives compile-time constants from K and PREFIX_BITS in
`build.rs:9-57` and `src/cbl.rs:19-32,65-67`.  We mirror the same derivations
here as a frozen dataclass; every JAX computation is specialised (jitted) per
config, which is the JAX analog of the reference's "recompile per K"
philosophy (`/root/reference/build.rs:1-8`).

Words are represented on device as little groups of big-endian uint32 limbs
(limb 0 = most significant).  uint32 is the native device integer width; wide
words (up to 125 bits for K=59) become 4-limb vectors.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache


def _ceil_log2_next_pow2(n: int) -> int:
    """ilog2(next_power_of_two(n)) as in `/root/reference/src/cbl.rs:66`."""
    assert n >= 1
    return (n - 1).bit_length() if n > 1 else 0


@dataclasses.dataclass(frozen=True)
class CBLConfig:
    """Compile-time constants of a CBL index.

    Invariants match the reference:
    - K odd, 1 <= K <= 59      (`/root/reference/build.rs:20-22`)
    - 1 <= PREFIX_BITS < 2K    (`/root/reference/build.rs:48-52`)
    - PREFIX_BITS <= 32        (`/root/reference/src/wordset/mod.rs:38-40`)
    """

    k: int = 25
    prefix_bits: int = 24

    def __post_init__(self) -> None:
        assert self.k >= 1, "K must be >= 1"
        assert self.k <= 59, "K must be <= 59"
        assert self.k % 2 == 1, "K must be odd"
        assert self.prefix_bits >= 1, "PREFIX_BITS must be >= 1"
        assert self.prefix_bits < 2 * self.k, "PREFIX_BITS must be < 2*K"
        assert self.prefix_bits <= 32, "PREFIX_BITS must be <= 32"
        assert self.suffix_bits > 0, "SUFFIX_BITS must be > 0"

    # --- derived constants (names follow the reference) ---

    @property
    def kmer_bits(self) -> int:
        """2K; `/root/reference/src/cbl.rs:19-21`."""
        return 2 * self.k

    @property
    def pos_bits(self) -> int:
        """Bits to store a rotation position; `/root/reference/src/cbl.rs:66`."""
        return _ceil_log2_next_pow2(self.kmer_bits)

    @property
    def n_bits(self) -> int:
        """Total packed-word width; `/root/reference/build.rs:37-38`."""
        return self.kmer_bits + self.pos_bits

    @property
    def suffix_bits(self) -> int:
        """`/root/reference/src/cbl.rs:29-32`."""
        return max(self.n_bits - self.prefix_bits, 0)

    # --- limb layout (device-native; no reference counterpart) ---

    @property
    def word_limbs(self) -> int:
        """uint32 limbs per packed (necklace, pos) word."""
        return (self.n_bits + 31) // 32

    @property
    def kmer_limbs(self) -> int:
        """uint32 limbs per 2K-bit k-mer.  Kept equal to `word_limbs` so the
        whole pipeline works on one uniform [.., L] shape."""
        return self.word_limbs

    @property
    def top_bits(self) -> int:
        """Significant bits in limb 0 of a packed word."""
        return self.n_bits - 32 * (self.word_limbs - 1)

    def __str__(self) -> str:  # pragma: no cover
        return f"CBLConfig(k={self.k}, prefix_bits={self.prefix_bits})"


@lru_cache(maxsize=None)
def get_config(k: int = 25, prefix_bits: int = 24) -> CBLConfig:
    return CBLConfig(k=k, prefix_bits=prefix_bits)


DEFAULT_CONFIG = get_config()
