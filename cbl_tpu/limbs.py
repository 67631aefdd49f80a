"""Multi-limb uint32 arithmetic for wide bit-packed words.

The reference stores k-mers and packed words in single Rust integers up to
u128 (`/root/reference/build.rs:59-68`).  Accelerators have no native
64/128-bit integer units, so we represent a W-bit value as L = ceil(W/32) uint32 limbs in
**big-endian limb order** (limb 0 = most significant).  Values are
right-aligned: the top `32*L - W` bits of limb 0 are zero.  With this layout
lexicographic limb order equals numeric order, which is what `jax.lax.sort`
with `num_keys=L` gives us.

All shift amounts here are Python ints (static), so the tiny loops over L
unroll into straight-line XLA ops.  Batch shape is `[..., L]`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

UINT = jnp.uint32
LIMB_BITS = 32
_U32_MAX = np.uint32(0xFFFFFFFF)


def zeros(batch_shape: tuple[int, ...], limbs: int):
    return jnp.zeros((*batch_shape, limbs), dtype=UINT)


def sentinel(batch_shape: tuple[int, ...], limbs: int):
    """All-ones rows; sorts after every valid word (a valid packed word can
    never be all-ones, see cbl_tpu.wordset)."""
    return jnp.full((*batch_shape, limbs), _U32_MAX, dtype=UINT)


def width_mask(width: int, limbs: int) -> np.ndarray:
    """Host-side [L] uint32 mask keeping the low `width` bits."""
    assert 0 <= width <= 32 * limbs
    out = np.zeros(limbs, dtype=np.uint32)
    for l in range(limbs):
        lo_bit = 32 * (limbs - 1 - l)  # bit index of this limb's LSB
        hi_bit = lo_bit + 32
        if width >= hi_bit:
            out[l] = 0xFFFFFFFF
        elif width > lo_bit:
            out[l] = np.uint32((1 << (width - lo_bit)) - 1)
    return out


def shift_left(x, s: int, out_limbs: int | None = None):
    """(x << s) over limb vectors; bits shifted past limb 0 are dropped."""
    L = x.shape[-1]
    Lo = out_limbs if out_limbs is not None else L
    q, r = divmod(s, LIMB_BITS)
    cols = []
    pad = L - Lo  # aligns input LSB with output LSB
    for l in range(Lo):
        src = l + pad + q
        col = x[..., src] if 0 <= src < L else jnp.zeros_like(x[..., 0])
        if r:
            col = col << r
            src2 = src + 1
            if 0 <= src2 < L:
                col = col | (x[..., src2] >> (LIMB_BITS - r))
        cols.append(col)
    return jnp.stack(cols, axis=-1)


def shift_right(x, s: int, out_limbs: int | None = None):
    """Logical (x >> s) over limb vectors."""
    L = x.shape[-1]
    Lo = out_limbs if out_limbs is not None else L
    q, r = divmod(s, LIMB_BITS)
    cols = []
    pad = L - Lo
    for l in range(Lo):
        src = l + pad - q
        col = x[..., src] if 0 <= src < L else jnp.zeros_like(x[..., 0])
        if r:
            col = col >> r
            src2 = src - 1
            if 0 <= src2 < L:
                col = col | (x[..., src2] << (LIMB_BITS - r))
        cols.append(col)
    return jnp.stack(cols, axis=-1)


def mask_width(x, width: int):
    """Keep only the low `width` bits."""
    m = jnp.asarray(width_mask(width, x.shape[-1]))
    return x & m


def bit_or(a, b):
    return a | b


def rotl1(x, width: int):
    """Rotate a `width`-bit value left by one bit.

    Semantics of one step of the reference rotation loop
    (`/root/reference/src/necklace/mod.rs:17-23`, there expressed as a right
    rotation; left/right choice is internal as long as positions match —
    see cbl_tpu.necklace).
    """
    L = x.shape[-1]
    # MSB of the value (bit width-1).
    msb_limb = L - 1 - (width - 1) // LIMB_BITS
    msb_off = (width - 1) % LIMB_BITS
    msb = (x[..., msb_limb] >> msb_off) & jnp.uint32(1)
    cols = []
    for l in range(L):
        col = x[..., l] << 1
        if l + 1 < L:
            col = col | (x[..., l + 1] >> (LIMB_BITS - 1))
        cols.append(col)
    out = jnp.stack(cols, axis=-1)
    out = mask_width(out, width)
    return out.at[..., L - 1].set(out[..., L - 1] | msb)


def cols_lt(a, b):
    """Lexicographic a < b over sequences of limb columns (column 0 most
    significant)."""
    res = a[-1] < b[-1]
    for l in range(len(a) - 2, -1, -1):
        res = (a[l] < b[l]) | ((a[l] == b[l]) & res)
    return res


def cols_le(a, b):
    """Lexicographic a <= b over sequences of limb columns (column 0 most
    significant)."""
    res = a[-1] <= b[-1]
    for l in range(len(a) - 2, -1, -1):
        res = (a[l] < b[l]) | ((a[l] == b[l]) & res)
    return res


def lt(a, b):
    """Lexicographic a < b over the limb axis (numeric less-than)."""
    L = a.shape[-1]
    return cols_lt([a[..., l] for l in range(L)], [b[..., l] for l in range(L)])


def eq(a, b):
    return jnp.all(a == b, axis=-1)


def le(a, b):
    return lt(a, b) | eq(a, b)


def popcount_parity(x):
    """Parity (0/1) of the total popcount; `/root/reference/src/kmer.rs:93-97`
    defines a k-mer as canonical iff this is 0."""
    pc = jax.lax.population_count(x)
    return jnp.sum(pc, axis=-1).astype(jnp.uint32) & jnp.uint32(1)


def extract_bits(x, lo: int, nbits: int):
    """Extract bit field [lo, lo+nbits) (lo = LSB index) into a uint32.

    Requires nbits <= 32."""
    assert nbits <= 32
    sh = shift_right(x, lo)
    val = sh[..., x.shape[-1] - 1]
    if nbits < 32:
        val = val & jnp.uint32((1 << nbits) - 1)
    return val


def _variable_shift_right(x, s, width: int, xp):
    """Logical right shift by a per-element amount s in [0, width].

    x: [..., L]; s: [...] integer array.  Used by the iteration/decode path
    (`revert_necklace_pos`, `/root/reference/src/necklace/mod.rs:29-31`),
    where the rotation amount is data-dependent.  `xp` is the array module
    (jnp on device, np for the host-side decode of `words_array` exports —
    same code, no device round-trip)."""
    L = x.shape[-1]
    s = s.astype(xp.uint32)
    q = (s // LIMB_BITS).astype(xp.int32)  # limb shift
    r = s % LIMB_BITS  # bit shift
    # First shift whole limbs by q via a gather along the limb axis.
    idx = xp.arange(L, dtype=xp.int32)  # output limb ids
    src = xp.broadcast_to(idx, x.shape[:-1] + (L,)) - q[..., None]
    valid = src >= 0
    src_c = xp.clip(src, 0, L - 1)
    shifted = xp.take_along_axis(x, src_c, axis=-1)
    shifted = xp.where(valid, shifted, 0).astype(xp.uint32)
    # Then shift by r bits with carry from the next-higher limb.
    hi = xp.concatenate(
        [xp.zeros_like(shifted[..., :1]), shifted[..., :-1]], axis=-1
    )
    r_ = r[..., None]
    out = xp.where(
        r_ == 0,
        shifted,
        (shifted >> r_) | ((hi << 1) << (xp.uint32(LIMB_BITS - 1) - r_)),
    )
    return out


def variable_shift_right(x, s, width: int):
    return _variable_shift_right(x, s, width, jnp)


def _variable_shift_left(x, s, width: int, xp):
    """Left shift by per-element amount, result masked to `width` bits."""
    L = x.shape[-1]
    s = s.astype(xp.uint32)
    q = (s // LIMB_BITS).astype(xp.int32)
    r = s % LIMB_BITS
    idx = xp.arange(L, dtype=xp.int32)
    src = xp.broadcast_to(idx, x.shape[:-1] + (L,)) + q[..., None]
    valid = src <= L - 1
    src_c = xp.clip(src, 0, L - 1)
    shifted = xp.take_along_axis(x, src_c, axis=-1)
    shifted = xp.where(valid, shifted, 0).astype(xp.uint32)
    lo = xp.concatenate(
        [shifted[..., 1:], xp.zeros_like(shifted[..., :1])], axis=-1
    )
    r_ = r[..., None]
    out = xp.where(
        r_ == 0,
        shifted,
        (shifted << r_) | ((lo >> 1) >> (xp.uint32(LIMB_BITS - 1) - r_)),
    )
    m = width_mask(width, L)
    return out & (m if xp is np else jnp.asarray(m))


def variable_shift_left(x, s, width: int):
    return _variable_shift_left(x, s, width, jnp)


def _variable_rotl(x, s, width: int, xp):
    left = _variable_shift_left(x, s, width, xp)
    right = _variable_shift_right(
        x,
        (xp.uint32(width) - s.astype(xp.uint32)) % xp.uint32(width),
        width,
        xp,
    )
    return xp.where((s % width == 0)[..., None], x, left | right)


def variable_rotl(x, s, width: int):
    """Rotate a width-bit value left by per-element amount s in [0, width)."""
    return _variable_rotl(x, s, width, jnp)


def np_variable_rotl(x: np.ndarray, s: np.ndarray, width: int) -> np.ndarray:
    """Host (numpy) twin of `variable_rotl` for export/decode paths."""
    return _variable_rotl(
        np.ascontiguousarray(x, dtype=np.uint32), s, width, np
    )


def np_shift_right(x: np.ndarray, s: int) -> np.ndarray:
    """Host twin of `shift_right` (static amount)."""
    L = x.shape[-1]
    q, r = divmod(s, LIMB_BITS)
    cols = []
    for l in range(L):
        src = l - q
        col = x[..., src] if 0 <= src < L else np.zeros_like(x[..., 0])
        if r:
            col = col >> r
            src2 = src - 1
            if 0 <= src2 < L:
                col = col | (x[..., src2] << (LIMB_BITS - r))
        cols.append(col)
    return np.stack(cols, axis=-1)


def np_extract_bits(x: np.ndarray, lo: int, nbits: int) -> np.ndarray:
    """Host twin of `extract_bits`."""
    assert nbits <= 32
    val = np_shift_right(x, lo)[..., x.shape[-1] - 1]
    if nbits < 32:
        val = val & np.uint32((1 << nbits) - 1)
    return val


# --- host-side conversions (tests, iteration, serde) ---


def from_py_ints(values, limbs: int) -> np.ndarray:
    """[N] python ints -> [N, L] uint32 big-endian limbs (vectorized)."""
    if limbs <= 2:
        v = np.asarray([int(x) for x in values], dtype=np.uint64)
        out = np.empty((len(v), limbs), dtype=np.uint32)
        out[:, limbs - 1] = (v & 0xFFFFFFFF).astype(np.uint32)
        if limbs == 2:
            out[:, 0] = (v >> np.uint64(32)).astype(np.uint32)
        return out
    out = np.zeros((len(values), limbs), dtype=np.uint32)
    for i, v in enumerate(values):
        v = int(v)
        for l in range(limbs - 1, -1, -1):
            out[i, l] = v & 0xFFFFFFFF
            v >>= 32
    return out


def to_py_ints(arr: np.ndarray) -> list[int]:
    """[N, L] uint32 limbs -> [N] python ints (vectorized)."""
    arr = np.asarray(arr, dtype=np.uint32)
    if arr.ndim == 1:
        arr = arr[None, :]
    L = arr.shape[1]
    if L == 1:
        return arr[:, 0].tolist()
    if L == 2:
        v = (arr[:, 0].astype(np.uint64) << np.uint64(32)) | arr[:, 1]
        return v.tolist()
    # wide path: combine uint64 pairs via object arithmetic per pair
    acc = None
    for pair_start in range(0, L, 2):
        if pair_start + 1 < L:
            part = (arr[:, pair_start].astype(np.uint64) << np.uint64(32)) | arr[
                :, pair_start + 1
            ]
            bits = 64
        else:
            part = arr[:, pair_start].astype(np.uint64)
            bits = 32
        part = part.astype(object)
        acc = part if acc is None else [(a << bits) | p for a, p in zip(acc, part)]
    return list(acc)
