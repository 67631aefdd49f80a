"""Index persistence (checkpoint/resume).

The reference serialises with bincode varint as a prefix->container map
(`/root/reference/src/cbl.rs:127-160`, `src/wordset/mod.rs:382-437`), a
*structure-canonicalising* format with no K/PREFIX_BITS header (§3.5 of
SURVEY.md).  Our format is the device-native analog: the dense sorted word
array itself (the index's canonical form), stored as a compressed .npz with
an explicit header so mismatched K/PREFIX_BITS fail loudly instead of
undefined behavior.  Semantic equality (same k-mer sets) is what the
reference's own equality harness demands; byte-compat with bincode is not a
goal (BASELINE.md).
"""

from __future__ import annotations

import numpy as np

MAGIC = "CBLX"
VERSION = 1


def save(cbl, path) -> None:
    # uncompressed: packed necklace words are near-incompressible and zlib
    # costs seconds per 100MB; the array IS the canonical index form.
    # Assemble the host array from bounded device->host chunks (avoids the
    # extra full-capacity transfer buffer a one-shot export would hold).
    ws = cbl.wordset
    ws.flush()
    words = None
    at = 0
    # 2^23 rows/chunk: still memory-bounded, half the transfers of the
    # default export chunk
    for block in ws.iter_words_chunks(1 << 23):
        if words is None:
            words = np.empty((ws.n, block.shape[1]), dtype=np.uint32)
        words[at : at + block.shape[0]] = block
        at += block.shape[0]
    if words is None:
        words = np.zeros((0, cbl.cfg.word_limbs), dtype=np.uint32)
    np.savez(
        path if str(path).endswith(".npz") else str(path),
        magic=np.array(MAGIC),
        version=np.array(VERSION),
        k=np.array(cbl.cfg.k),
        prefix_bits=np.array(cbl.cfg.prefix_bits),
        canonical=np.array(cbl.canonical),
        words=words,
    )


def _npz_path(path) -> str:
    import os

    p = str(path)
    if os.path.exists(p):
        return p
    if os.path.exists(p + ".npz"):
        return p + ".npz"
    return p


def load(path):
    from .cbl import CBL

    with np.load(_npz_path(path)) as z:
        if str(z["magic"]) != MAGIC:
            raise ValueError(f"{path}: not a cbl_tpu index file")
        version = int(z["version"])
        if version > VERSION:
            raise ValueError(f"{path}: unsupported index version {version}")
        k = int(z["k"])
        prefix_bits = int(z["prefix_bits"])
        canonical = bool(z["canonical"])
        words = z["words"]
    cbl = CBL(k=k, prefix_bits=prefix_bits, canonical=canonical)
    n = int(words.shape[0])
    if n:
        # saved rows are sorted + unique: install them directly as the
        # device array (sentinel-padded to a power of two) — no device
        # kernel, no one-off-shape compile on the load path
        from .wordset import MIN_CAP, _next_pow2

        ws = cbl.wordset
        cap = max(_next_pow2(n), MIN_CAP)
        padded = np.full((cap, words.shape[1]), 0xFFFFFFFF, dtype=np.uint32)
        padded[:n] = words
        import jax.numpy as jnp

        ws.data = jnp.asarray(padded)
        ws.capacity = cap
        ws._n_host = n
        ws._n_upper = n
        ws._n_dev = None
    return cbl
