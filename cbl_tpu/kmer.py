"""2-bit k-mer encoding and batched sliding-window extraction.

Reference semantics (`/root/reference/src/kmer.rs`):
- base encoding A=0b00, C=0b01, T=0b10, G=0b11 (`src/kmer.rs:11`); this
  non-standard order makes complement = XOR 0b10 (`src/kmer.rs:217-220`).
- lowercase accepted, every other byte is *skipped* (filter_map,
  `src/kmer.rs:131-135`), i.e. removed from the sequence before k-mers
  are formed.
- reverse complement = reverse base order + complement each base
  (`src/kmer.rs:293-348`).
- a k-mer is canonical iff its packed integer has even popcount
  (`src/kmer.rs:93-97`); valid because K is odd.

Accelerator design: instead of the reference's per-base streaming loop
(`src/kmer.rs:163-193`), we pack a whole base stream into uint32 words
(16 bases/word, big-endian) and gather every k-mer's limbs with vectorized
shifts — thousands of k-mers per XLA op.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np

from . import limbs
from .config import CBLConfig

BASES_PER_WORD = 16

# ASCII -> 2-bit code; 255 = invalid (skipped).
NUC_LOOKUP = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"ACTG"):
    NUC_LOOKUP[_c] = _i
    NUC_LOOKUP[_c + 32] = _i  # lowercase
BASE_LOOKUP = np.frombuffer(b"ACTG", dtype=np.uint8)


def encode_seq(seq) -> np.ndarray:
    """ASCII sequence -> [M] uint8 base codes with invalid bytes removed.

    Matches the reference's filter_map semantics (`src/kmer.rs:131-135`)."""
    if isinstance(seq, str):
        seq = seq.encode()
    raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    codes = NUC_LOOKUP[raw]
    return codes[codes != 255]


def decode_codes(codes: np.ndarray) -> bytes:
    """[..., K] uint8 base codes -> ASCII."""
    return BASE_LOOKUP[np.asarray(codes)].tobytes()


def np_pack_stream(codes: np.ndarray) -> np.ndarray:
    """Host-side `pack_stream`: [S] uint8 codes (S%16==0) -> [S/16] uint32.
    Packing on host cuts host->device transfer 8x.  Uses the native C++
    packer (io/native/fastx.cpp: cbl_pack_stream, SIMD-vectorized) with a
    numpy fallback."""
    from . import io as _io

    out = _io.pack_stream_native(codes)
    if out is not None:
        return out
    c = codes.reshape(-1, BASES_PER_WORD).astype(np.uint32)
    word = np.zeros(c.shape[0], dtype=np.uint32)
    for j in range(BASES_PER_WORD):
        word = (word << np.uint32(2)) | c[:, j]
    return word


def pack_stream(codes):
    """[S] uint8 base codes (S % 16 == 0) -> [S/16] uint32, base s at bits
    [30 - 2*(s%16), 32 - 2*(s%16)) of word s//16 (big-endian bases)."""
    S = codes.shape[0]
    assert S % BASES_PER_WORD == 0
    c = codes.astype(jnp.uint32).reshape(S // BASES_PER_WORD, BASES_PER_WORD)
    shifts = jnp.arange(30, -1, -2, dtype=jnp.uint32)
    return jnp.sum(c << shifts, axis=1, dtype=jnp.uint32)


def extract_kmers(stream, n_kmers: int, cfg: CBLConfig):
    """Extract all k-mers of a packed base stream WITHOUT gathers.

    stream: [S/16] uint32 from `pack_stream` (the first k-mer starts at base
    0).  Returns [n_kmers, L] uint32 limbs, right-aligned 2K-bit values.
    Requires n_kmers % 16 == 0 (chunk sizes are powers of two >= 4096).

    K-mer starts with the same (i mod 16) phase read the stream at the same
    static bit offset within consecutive words, so the 16 phases become 16
    static strided slices + constant shifts — pure elementwise work, no
    gathers.  Replaces
    the reference's sliding `append` loop (`src/kmer.rs:163-193`).
    """
    W = cfg.kmer_bits
    L = cfg.kmer_limbs
    n16 = (n_kmers + BASES_PER_WORD - 1) // BASES_PER_WORD * BASES_PER_WORD
    n_words = n16 // BASES_PER_WORD
    # Prepend L zero words (for value bits above W) and append enough words
    # for the deepest phase read.
    S = jnp.concatenate(
        [
            jnp.zeros((L,), dtype=jnp.uint32),
            stream,
            jnp.zeros((L + 8,), dtype=jnp.uint32),
        ]
    )
    # phase_cols[p][l]: [n_words] limb l of k-mers starting at i = 16*j + p
    out = jnp.zeros((16, n_words, L), dtype=jnp.uint32)
    for p in range(BASES_PER_WORD):
        cols = []
        for l in range(L):
            # source bits end (exclusive) at stream bit 2i + W - 32*(L-1-l),
            # with i = 16 j + p; +32L for the zero-pad.
            start = 2 * p + W - 32 * (L - l) + 32 * L  # + 32 j
            w0, off = divmod(start, 32)
            s0 = jax.lax.dynamic_slice_in_dim(S, w0, n_words)
            if off == 0:
                col = s0
            else:
                s1 = jax.lax.dynamic_slice_in_dim(S, w0 + 1, n_words)
                col = (s0 << off) | (s1 >> (32 - off))
            cols.append(col)
        out = out.at[p].set(jnp.stack(cols, axis=-1))
    # interleave phases: [16, n_words, L] -> [n_words, 16, L] -> [n16, L]
    kmers = jnp.transpose(out, (1, 0, 2)).reshape(n16, L)[:n_kmers]
    return limbs.mask_width(kmers, W)


def _bit_reverse_bases_limb(x):
    """Reverse the 16 bases (2-bit groups) inside each uint32 limb."""
    x = (
        (x >> 24)
        | ((x >> 8) & jnp.uint32(0x0000FF00))
        | ((x << 8) & jnp.uint32(0x00FF0000))
        | (x << 24)
    )
    x = ((x >> 4) & jnp.uint32(0x0F0F0F0F)) | ((x & jnp.uint32(0x0F0F0F0F)) << 4)
    x = ((x >> 2) & jnp.uint32(0x33333333)) | ((x & jnp.uint32(0x33333333)) << 2)
    return x


def revcomp(kmers, cfg: CBLConfig):
    """Batched reverse complement of [N, L] k-mer limbs.

    Same bit-trick structure as `/root/reference/src/kmer.rs:326-335`,
    lifted to limb vectors: reverse bases of the full 32L-bit register
    (per-limb 2-bit-group reversal + limb-order reversal), realign, then
    complement by XOR 0b10 per base.
    """
    W = cfg.kmer_bits
    L = kmers.shape[-1]
    rev = _bit_reverse_bases_limb(kmers)[..., ::-1]
    rev = limbs.shift_right(rev, 32 * L - W)
    comp_mask = jnp.asarray(
        limbs.width_mask(W, L) & np.uint32(0xAAAAAAAA)
    )
    return rev ^ comp_mask


def is_canonical(kmers):
    """True where popcount is even; `/root/reference/src/kmer.rs:93-97`."""
    return limbs.popcount_parity(kmers) == 0


def canonicalize(kmers, cfg: CBLConfig):
    """Per-row canonical form; `/root/reference/src/kmer.rs:99-106`."""
    canon = is_canonical(kmers)
    rc = revcomp(kmers, cfg)
    return jnp.where(canon[..., None], kmers, rc), canon


def unpack_bases(kmers, cfg: CBLConfig):
    """[N, L] k-mer limbs -> [N, K] uint8 base codes (first base first)."""
    W = cfg.kmer_bits
    L = kmers.shape[-1]
    cols = []
    for j in range(cfg.k):
        lo = W - 2 - 2 * j  # LSB index of base j; always even
        limb = L - 1 - lo // 32
        off = lo % 32
        cols.append(((kmers[..., limb] >> off) & jnp.uint32(3)).astype(jnp.uint8))
    return jnp.stack(cols, axis=-1)


def np_unpack_bases(kmers: np.ndarray, cfg: CBLConfig) -> np.ndarray:
    """Host twin of `unpack_bases` (export/list path)."""
    W = cfg.kmer_bits
    L = kmers.shape[-1]
    cols = []
    for j in range(cfg.k):
        lo = W - 2 - 2 * j
        limb = L - 1 - lo // 32
        off = lo % 32
        cols.append(((kmers[..., limb] >> np.uint32(off)) & np.uint32(3)
                     ).astype(np.uint8))
    return np.stack(cols, axis=-1)


# --- k-mer neighborhood ops (`/root/reference/src/kmer.rs:61-90`) ---


def extend_kmer(v: int, base: int) -> int:
    """Append a base without dropping the first (`src/kmer.rs:61-63`)."""
    return (v << 2) | base


def append_kmer(v: int, base: int, k: int) -> int:
    """Append a base, dropping the first (`src/kmer.rs:70-72`)."""
    return ((v << 2) | base) & ((1 << (2 * k)) - 1)


def prepend_kmer(v: int, base: int, k: int) -> int:
    """Prepend a base, dropping the last (`src/kmer.rs:76-78`)."""
    return (v >> 2) | (base << (2 * (k - 1)))


def successors(v: int, k: int) -> list[int]:
    """The 4 k-mers reachable by appending a base (`src/kmer.rs:82-85`)."""
    return [append_kmer(v, b, k) for b in range(4)]


def predecessors(v: int, k: int) -> list[int]:
    """The 4 k-mers reachable by prepending a base (`src/kmer.rs:87-90`)."""
    return [prepend_kmer(v, b, k) for b in range(4)]


# --- host-side oracle helpers (tests / tiny inputs) ---


def kmer_to_int(codes) -> int:
    v = 0
    for c in codes:
        v = (v << 2) | int(c)
    return v


def int_to_codes(v: int, k: int) -> np.ndarray:
    return np.array([(v >> (2 * (k - 1 - j))) & 3 for j in range(k)], dtype=np.uint8)


def py_revcomp(v: int, k: int) -> int:
    out = 0
    for _ in range(k):
        out = (out << 2) | ((v & 3) ^ 0b10)
        v >>= 2
    return out


def py_is_canonical(v: int) -> bool:
    return bin(v).count("1") % 2 == 0
