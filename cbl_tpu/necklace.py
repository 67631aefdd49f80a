"""Batched necklace (smallest cyclic rotation) computation.

Reference: `/root/reference/src/necklace/mod.rs:13-31`.  The necklace of a
2K-bit word is its minimum over all 2K bit-rotations; the position `pos` is
the smallest left-rotation amount achieving the minimum (the reference's
`rot <= necklace` update over decreasing `i` keeps the smallest position).
`revert_necklace_pos(necklace, pos)` rotates right by `pos` to recover the
word.

The reference optimises the sequential stream with a monotone minimizer queue
(`src/necklace/queue.rs`, `src/necklace/minimizer.rs`) because each update must
be O(1) on a CPU.  On the accelerator the whole batch is data-parallel, so
we evaluate all 2K rotations of every k-mer at once — a few integer ops per
rotation per word.  The results are bit-identical to the reference's
`necklace_pos` by construction.

The packed word layout matches `/root/reference/src/cbl.rs:181-195`:
`word = (necklace << POS_BITS) | pos`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import limbs
from .config import CBLConfig


def necklace_pos(kmers, cfg: CBLConfig):
    """[N, L] k-mer limbs -> (necklace [N, L], pos [N] uint32).

    necklace = min over p in [0, 2K) of rotl(kmer, p); pos = smallest
    argmin.  Oracle: `/root/reference/src/necklace/mod.rs:13-25`.

    On a GPU this is the Pallas kernel `ops/necklace_triton.py`, which
    keeps the (rot, best, pos) carry in registers for a block of k-mers;
    elsewhere the XLA chain `necklace_chain`.
    """
    if jax.default_backend() == "gpu":
        from .ops.necklace_triton import necklace_pos_kernel

        return necklace_pos_kernel(kmers, cfg.kmer_bits)
    return necklace_chain(kmers, cfg.kmer_bits)


def necklace_chain(kmers, width: int):
    """`necklace_pos` as an unrolled XLA chain (python loop, static trip
    count <= 117).  On a GPU, XLA splits it into about two kernels per
    rotation step, each moving the whole carry through device memory."""
    rot, best = kmers, kmers
    pos = jnp.zeros(kmers.shape[:-1], dtype=jnp.uint32)
    for p in range(1, width):
        rot = limbs.rotl1(rot, width)
        better = limbs.lt(rot, best)
        best = jnp.where(better[..., None], rot, best)
        pos = jnp.where(better, jnp.uint32(p), pos)
    return best, pos


def revert_necklace_pos(necklace, pos, cfg: CBLConfig):
    """Rotate right by pos to recover the original k-mer;
    `/root/reference/src/necklace/mod.rs:29-31`."""
    W = cfg.kmer_bits
    s = (jnp.uint32(W) - pos.astype(jnp.uint32)) % jnp.uint32(W)
    return limbs.variable_rotl(necklace, s, W)


def pack_word(necklace, pos, cfg: CBLConfig):
    """word = (necklace << POS_BITS) | pos; `/root/reference/src/cbl.rs:181-184`."""
    word = limbs.shift_left(necklace, cfg.pos_bits)
    L = word.shape[-1]
    return word.at[..., L - 1].set(word[..., L - 1] | pos.astype(jnp.uint32))


def unpack_word(word, cfg: CBLConfig):
    """word -> (necklace, pos); `/root/reference/src/cbl.rs:188-195`."""
    pos = limbs.extract_bits(word, 0, cfg.pos_bits)
    necklace = limbs.shift_right(word, cfg.pos_bits)
    return necklace, pos


def word_to_kmer(word, cfg: CBLConfig):
    """Recover k-mer limbs from a packed word; `/root/reference/src/cbl.rs:210-215`."""
    necklace, pos = unpack_word(word, cfg)
    return revert_necklace_pos(necklace, pos, cfg)


def word_prefix(word, cfg: CBLConfig):
    """prefix = word >> SUFFIX_BITS as uint32;
    `/root/reference/src/wordset/mod.rs:63-71`."""
    return limbs.extract_bits(word, cfg.suffix_bits, cfg.prefix_bits)


# --- host-side decode (export/list paths) ---


def np_word_to_kmer(words: "np.ndarray", cfg: CBLConfig) -> "np.ndarray":
    """Host (numpy) twin of `word_to_kmer`: decode exported packed words
    without any device round-trip — the `list` path is bound by the
    device->host copy, so decode runs where the bytes already are."""
    import numpy as np

    W = cfg.kmer_bits
    words = np.ascontiguousarray(words, dtype=np.uint32)
    pos = limbs.np_extract_bits(words, 0, cfg.pos_bits)
    necklace = limbs.np_shift_right(words, cfg.pos_bits)
    s = (np.uint32(W) - pos.astype(np.uint32)) % np.uint32(W)
    return limbs.np_variable_rotl(necklace, s, W)


# --- host-side oracle (tests) ---


def py_necklace_pos(word: int, bits: int) -> tuple[int, int]:
    """Pure-python transcription of the necklace definition for testing."""
    best = word
    pos = 0
    mask = (1 << bits) - 1
    for p in range(1, bits):
        rot = ((word << p) & mask) | (word >> (bits - p))
        if rot < best:
            best = rot
            pos = p
    return best, pos
