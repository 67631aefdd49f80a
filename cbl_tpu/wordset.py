"""DeviceWordSet — the device-resident dynamic word-set store.

The reference keeps words in a prefix-rank bitvector + tiered vector +
adaptive vec/trie suffix containers (`/root/reference/src/wordset/mod.rs:18-26`,
`cxx/rank_bv.h`, `cxx/tiered_vec.h`, `src/trievec/mod.rs`).  Those are
CPU-latency pointer machines.  On the accelerator we re-express the same
*set semantics* as one dense, globally **sorted flat array of multi-limb
words** resident in device memory:

- membership      = vectorized binary search        (was: rank + bucket scan)
- insert batch    = concat + sort + dedup + compact (was: per-bucket inserts)
- remove batch    = search + mask + compact         (was: per-bucket removes)
- set algebra     = sorted-merge scans              (was: per-bucket 2-pointer
                                                     merges, `set_ops.rs`)
- iteration order = ascending word order, i.e. prefix-major with sorted
                    suffixes (the reference's trie-bucket order,
                    `src/wordset/mod.rs:349-361`)

A capacity-padded layout keeps XLA shapes static: the array has power-of-two
capacity and unused rows hold the sentinel 0xFFFF..FF, which sorts after every
valid word.  (A packed word can never be all-ones: its `pos` field is < 2K
while an all-ones pos field would require pos = 2^POS_BITS-1 >= 2K; only K=1
makes 2K a power of two and there N_BITS=3 < 32.)

Inserts are amortised through a fixed-size **pending buffer**: word batches
are appended with `dynamic_update_slice` (cheap) and folded into the sorted
array in one large merge when the buffer fills or a query forces a flush.
This mirrors the amortisation role of the reference's 2048-k-mer chunking
(`/root/reference/src/cbl.rs:67,239-243`) at HBM-friendly batch sizes.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from . import limbs
from .config import CBLConfig
from .ops.merge import (
    merge_sorted_pair,
    merge_with_unsorted,
    sort_cols,
    use_merge_kernel,
)

MIN_CAP = 4096


def _donate_if_aliasable(*static_argnames):
    """jit a kernel twice — donating arg 0 and not — and dispatch per
    call: donate only when arg 0's leading dim equals the kernel's
    `out_cap` (the [out_cap, L] output it would alias).  Capacity-changing
    calls (growth steps, quantize jumps) silently copied the "donated"
    buffer and warned; now every remaining donation actually aliases.
    Convention: `out_cap` is the last positional argument."""
    def deco(fn):
        don = partial(jax.jit, static_argnames=static_argnames,
                      donate_argnums=(0,))(fn)
        plain = partial(jax.jit, static_argnames=static_argnames)(fn)

        def wrapper(*args, **kw):
            out_cap = kw.get("out_cap", args[-1])
            use = don if args[0].shape[0] == out_cap else plain
            return use(*args, **kw)

        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        return wrapper

    return deco


@lru_cache(maxsize=None)
def _chunk_slice_fn(cap: int, chunk: int):
    """jitted ([cap, L] data, start) -> [chunk, L] block (start traced, so
    one program serves every chunk of an export)."""
    return jax.jit(
        lambda d, i: jax.lax.dynamic_slice_in_dim(d, i, chunk, axis=0)
    )
DEFAULT_PENDING_CAP = 1 << 21
_U32_MAX = np.uint32(0xFFFFFFFF)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


def _quantize_cap(n: int, frac_log: int = 3) -> int:
    """Capacity rounded UP to a 1/8-pow2 step (mantissa 8..16 over a
    power of two, never below MIN_CAP, always a multiple of 4096):
    <=12.5% sentinel padding with a
    bounded family of shapes (~8 per octave), vs next_pow2's up-to-2x
    padding or exact sizes' compile-per-call."""
    if n <= MIN_CAP:
        return MIN_CAP
    k = max((n - 1).bit_length() - 1 - frac_log, 12)
    step = 1 << k
    return -(-n // step) * step


def sort_rows(x):
    """Sort [N, L] rows ascending (lexicographic over limbs = numeric)."""
    L = x.shape[-1]
    cols = tuple(x[:, l] for l in range(L))
    out = sort_cols(cols)
    return jnp.stack(out, axis=-1)


def _valid_mask(rows):
    """True for non-sentinel rows."""
    return ~jnp.all(rows == _U32_MAX, axis=-1)


def _compact(rows, keep, out_cap: int):
    """Scatter `rows[keep]` to the front of a sentinel-filled [out_cap, L]
    array, preserving order.  Returns (out, count)."""
    L = rows.shape[-1]
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    idx = jnp.where(keep, pos, out_cap)
    out = jnp.full((out_cap, L), _U32_MAX, dtype=jnp.uint32)
    out = out.at[idx].set(rows, mode="drop")
    return out, jnp.sum(keep.astype(jnp.int32))





@_donate_if_aliasable("op", "out_cap")
def _setop_sort_kernel(a, b, op: str, out_cap: int):
    """All binary set operations as ONE tagged sort + adjacency logic +
    compaction-by-sorting.  No gathers/scatters at all.

    Semantics (`/root/reference/src/wordset/set_ops.rs`):
      union:   a ∪ b     (b may contain duplicates/sentinels — insert path)
      remove:  a \\ b     (b = removal batch, duplicates fine)
      inter:   a ∩ b     (both duplicate-free)
      diff:    a \\ b     (both duplicate-free; alias of remove)
      symdiff: a ∆ b     (both duplicate-free)

    The tag column (a=1, b=0) makes b-rows sort FIRST among equal words, so
    "predecessor equals me" tells an a-row whether its word is in b.
    """
    L = a.shape[-1]
    rows = jnp.concatenate([a, b], axis=0)
    tag = jnp.concatenate(
        [
            jnp.ones((a.shape[0],), jnp.uint32),
            jnp.zeros((b.shape[0],), jnp.uint32),
        ]
    )
    ops = tuple(rows[:, l] for l in range(L)) + (tag,)
    sorted_ops = sort_cols(ops)
    s = jnp.stack(sorted_ops[:L], axis=-1)
    is_a = sorted_ops[L] == 1
    valid = _valid_mask(s)
    prev_eq = jnp.concatenate(
        [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
    )
    if op == "union":
        keep = valid & ~prev_eq
    elif op in ("remove", "diff"):
        keep = valid & is_a & ~prev_eq
    elif op == "inter":
        keep = valid & is_a & prev_eq
    elif op == "symdiff":
        next_eq = jnp.concatenate(
            [limbs.eq(s[:-1], s[1:]), jnp.zeros((1,), dtype=bool)]
        )
        keep = valid & ~prev_eq & ~next_eq
    else:  # pragma: no cover
        raise ValueError(op)
    s = jnp.where(keep[:, None], s, _U32_MAX)
    s = sort_rows(s)
    total = s.shape[0]
    if out_cap <= total:
        out = s[:out_cap]
    else:
        pad = jnp.full((out_cap - total, L), _U32_MAX, dtype=jnp.uint32)
        out = jnp.concatenate([s, pad], axis=0)
    return out, jnp.sum(keep.astype(jnp.int32))


@_donate_if_aliasable("op", "out_cap")
def _setop_sort_kernel_packed(a, b, op: str, out_cap: int):
    """`_setop_sort_kernel` with the operand tag PACKED into the key's low
    bit (rows shifted left one bit; a-rows get tag 1, so b-rows still sort
    FIRST among equal words).  The tagged sort then moves L columns instead
    of L+1.  Requires n_bits <= 32*L - 2 (caller dispatches)."""
    L = a.shape[-1]
    one = jnp.uint32(1)
    at = _shift_tag(a, 1)
    bt = _shift_tag(b, 0)  # preserves 1-limb sentinels (see _shift_tag)
    rows = jnp.concatenate([at, bt], axis=0)
    cols = tuple(rows[:, l] for l in range(L))
    sc = sort_cols(cols)
    is_a = (sc[L - 1] & one) == one
    valid = sc[0] != _U32_MAX  # see _count_hits_kernel_packed
    # word-level adjacency (ignore the tag bit in the last limb)
    eq_next = (sc[L - 1][1:] >> 1) == (sc[L - 1][:-1] >> 1)
    for l in range(L - 1):
        eq_next = eq_next & (sc[l][1:] == sc[l][:-1])
    prev_eq = jnp.concatenate([jnp.zeros((1,), dtype=bool), eq_next])
    if op == "union":
        keep = valid & ~prev_eq
    elif op in ("remove", "diff"):
        keep = valid & is_a & ~prev_eq
    elif op == "inter":
        keep = valid & is_a & prev_eq
    elif op == "symdiff":
        next_eq = jnp.concatenate([eq_next, jnp.zeros((1,), dtype=bool)])
        keep = valid & ~prev_eq & ~next_eq
    else:  # pragma: no cover
        raise ValueError(op)
    s = jnp.stack(sc, axis=-1)
    s = limbs.shift_right(s, 1)  # un-tag
    s = jnp.where(keep[:, None], s, _U32_MAX)
    s = sort_rows(s)
    total = s.shape[0]
    if out_cap <= total:
        out = s[:out_cap]
    else:
        pad = jnp.full((out_cap - total, L), _U32_MAX, dtype=jnp.uint32)
        out = jnp.concatenate([s, pad], axis=0)
    return out, jnp.sum(keep.astype(jnp.int32))


def _setop_kernel_for(cfg: CBLConfig):
    L = cfg.word_limbs
    return (
        _setop_sort_kernel_packed
        if cfg.n_bits <= 32 * L - 2
        else _setop_sort_kernel
    )


@jax.jit
def _union_merge_kernel(a, b):
    """Union of two sorted CONTIGUOUS operands in ONE streamed merge pass
    (the merge kernel, `ops/merge_triton.py`), KEEPING duplicate word copies:
    the result is a valid `_dups` state and the distinct count is one
    adjacency pass.  No marking, no compaction."""
    L = a.shape[-1]
    cols = merge_sorted_pair(
        tuple(a[:, l] for l in range(L)),
        tuple(b[:, l] for l in range(L)),
    )
    s = jnp.stack(cols, axis=-1)
    return s, _distinct_count(s)


@partial(jax.jit, static_argnames=("op",))
def _setop_merge_kernel(a, b, op: str):
    """inter/diff/symdiff of two sorted CONTIGUOUS operands in ONE merge
    pass of the low-bit-tagged runs (the packed-tag trick: rows shifted
    left one bit stay sorted) + word-adjacency marks; non-kept rows are
    blanked IN PLACE, so the result is a `_holes` state — no compaction
    sort.  Requires n_bits <= 32*L - 2 (caller dispatches).  Duplicate
    rows in `a` are dropped by the same adjacency rule."""
    L = a.shape[-1]
    one = jnp.uint32(1)
    at = _shift_tag(a, 1)
    bt = _shift_tag(b, 0)  # preserves 1-limb sentinels (see _shift_tag)
    # equal words order (b tag 0) before (a tag 1) — same order the tagged
    # sort kernels produce
    sc = merge_sorted_pair(
        tuple(bt[:, l] for l in range(L)),
        tuple(at[:, l] for l in range(L)),
    )
    is_a = (sc[L - 1] & one) == one
    valid = sc[0] != _U32_MAX  # see _count_hits_kernel_packed
    eq_next = (sc[L - 1][1:] >> 1) == (sc[L - 1][:-1] >> 1)
    for l in range(L - 1):
        eq_next = eq_next & (sc[l][1:] == sc[l][:-1])
    prev_eq = jnp.concatenate([jnp.zeros((1,), dtype=bool), eq_next])
    if op in ("remove", "diff"):
        keep = valid & is_a & ~prev_eq
    elif op == "inter":
        keep = valid & is_a & prev_eq
    elif op == "symdiff":
        next_eq = jnp.concatenate([eq_next, jnp.zeros((1,), dtype=bool)])
        keep = valid & ~prev_eq & ~next_eq
    else:  # pragma: no cover
        raise ValueError(op)
    s = jnp.stack(sc, axis=-1)
    s = limbs.shift_right(s, 1)  # un-tag
    s = jnp.where(keep[:, None], s, _U32_MAX)
    return s, jnp.sum(keep.astype(jnp.int32))


@jax.jit
def _merge_sortmark_kernel(data, batch):
    # (no donation: the output shape |data|+|batch| can never alias an input)
    """Sorted-set union in ONE sort, deferring compaction: duplicate and
    sentinel rows are overwritten with the sentinel IN PLACE, leaving a
    'sorted with holes' array — valid rows ascending and unique, interspersed
    with sentinel rows.  Holes are harmless to sort-joins and to further
    merges (sentinels drop out of the next sort); paths that need a
    contiguous prefix (binary search, radix windows, export) compact first
    via `_compact_sort_kernel`.  Retained as the fallback when `data` is
    not monotone (holes from a previous call); the default insert merge is
    `_merge_keepdups_kernel`."""
    cat = jnp.concatenate([data, batch], axis=0)
    s = sort_rows(cat)
    prev_eq = jnp.concatenate(
        [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
    )
    keep = _valid_mask(s) & ~prev_eq
    s = jnp.where(keep[:, None], s, _U32_MAX)
    return s, jnp.sum(keep.astype(jnp.int32))


def _distinct_count(s):
    """Distinct valid rows of a sorted (duplicates-adjacent) array."""
    prev_eq = jnp.concatenate(
        [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
    )
    return jnp.sum((_valid_mask(s) & ~prev_eq).astype(jnp.int32))


@jax.jit
def _merge_keepdups_kernel(data, batch):
    """Insert-merge of a sorted index with an unsorted batch, deferring
    dedup: duplicate rows are KEPT — no marking pass, no holes — so the
    array stays monotone and the next merge and the merge-join stay
    cheap; the distinct count is one adjacency pass.  `data` must be
    sorted ascending and contiguous (duplicates fine).

    The combine is `ops.merge.merge_with_unsorted`: on the kernel route
    it sorts only the batch and runs the one-pass merge; otherwise one
    lax.sort of the concatenation.  Returns ([C+P, L] merged,
    n_distinct)."""
    L = data.shape[-1]
    cols = merge_with_unsorted(
        tuple(data[:, l] for l in range(L)),
        tuple(batch[:, l] for l in range(L)),
    )
    s = jnp.stack(cols, axis=-1)
    return s, _distinct_count(s)


@jax.jit
def _merge_sortedbatch_kernel(data, batch):
    """`_merge_keepdups_kernel` when the batch is ALREADY sorted (the
    insert stream pipeline sorts inside its fused program so the rows are
    reusable by later joins): one merge pass, no batch sort."""
    L = data.shape[-1]
    cols = merge_sorted_pair(
        tuple(data[:, l] for l in range(L)),
        tuple(batch[:, l] for l in range(L)),
    )
    s = jnp.stack(cols, axis=-1)
    return s, _distinct_count(s)


@jax.jit
def _build_sorted_kernel(batch):
    """Sort a fresh batch and count distinct rows (empty-index insert)."""
    s = sort_rows(batch)
    return s, _distinct_count(s)


@_donate_if_aliasable("out_cap")
def _dedup_sorted_kernel(data, out_cap: int):
    """Dedup an already-sorted (valid-first, duplicates allowed) array:
    mark adjacent duplicates as the sentinel, one re-sort, truncate/pad.
    Used to lazily canonicalize a fused bulk build (which keeps duplicate
    rows to save a sort on the hot path)."""
    L = data.shape[-1]
    prev_eq = jnp.concatenate(
        [jnp.zeros((1,), dtype=bool), limbs.eq(data[1:], data[:-1])]
    )
    keep = _valid_mask(data) & ~prev_eq
    s = jnp.where(keep[:, None], data, _U32_MAX)
    s = sort_rows(s)
    total = s.shape[0]
    if out_cap <= total:
        out = s[:out_cap]
    else:
        pad = jnp.full((out_cap - total, L), _U32_MAX, dtype=jnp.uint32)
        out = jnp.concatenate([s, pad], axis=0)
    return out, jnp.sum(keep.astype(jnp.int32))


@_donate_if_aliasable("out_cap")
def _compact_sort_kernel(data, out_cap: int):
    """Re-sort a 'sorted with holes' array so sentinels fall to the end,
    then truncate/pad to out_cap.  Input rows are already unique."""
    L = data.shape[-1]
    s = sort_rows(data)
    n = jnp.sum(_valid_mask(s).astype(jnp.int32))
    total = s.shape[0]
    if out_cap <= total:
        out = s[:out_cap]
    else:
        pad = jnp.full((out_cap - total, L), _U32_MAX, dtype=jnp.uint32)
        out = jnp.concatenate([s, pad], axis=0)
    return out, n


@_donate_if_aliasable("out_cap")
def _merge_sortcompact_kernel(data, batch, out_cap: int):
    """Sorted-set union via two sorts and NO scatters/gathers:
    compaction-by-sorting (mark dups/invalid rows as the all-ones
    sentinel, re-sort so they fall to the end).  Total: 2 sorts of C+P.
    """
    L = data.shape[-1]
    cat = jnp.concatenate([data, batch], axis=0)
    s = sort_rows(cat)
    prev_eq = jnp.concatenate(
        [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
    )
    keep = _valid_mask(s) & ~prev_eq
    s = jnp.where(keep[:, None], s, _U32_MAX)
    s = sort_rows(s)
    total = s.shape[0]
    if out_cap <= total:
        out = s[:out_cap]
    else:
        pad = jnp.full((out_cap - total, L), _U32_MAX, dtype=jnp.uint32)
        out = jnp.concatenate([s, pad], axis=0)
    return out, jnp.sum(keep.astype(jnp.int32))


def _sortjoin_hits(sorted_cols, is_data):
    """Per-row bool: 'this row's equal-word run contains a data row' —
    computed from the L sorted key COLUMNS (never materialising [N, L] rows)
    and without requiring the data row to sort first in its run.

    Segmented broadcast WITHOUT a custom-combiner scan (associative_scan
    builds a log-depth slice/concat HLO program — slow to compile and run at
    10M+ rows): runs get increasing 1-based ids by cumsum; data rows publish
    their run id; a forward cummax covers rows after the data row, a reverse
    cummin (ids increase, so the smallest id at-or-after me is my own run's)
    covers rows before it.  Also returns the per-row valid (non-sentinel)
    mask."""
    L = len(sorted_cols)
    neq = sorted_cols[0][1:] != sorted_cols[0][:-1]
    valid_inv = sorted_cols[0] == _U32_MAX
    for l in range(1, L):
        neq = neq | (sorted_cols[l][1:] != sorted_cols[l][:-1])
        valid_inv = valid_inv & (sorted_cols[l] == _U32_MAX)
    run_start = jnp.concatenate([jnp.ones((1,), dtype=bool), neq])
    run_id = jnp.cumsum(run_start.astype(jnp.int32))
    fwd = jax.lax.cummax(jnp.where(is_data, run_id, 0))
    bwd = jax.lax.cummin(
        jnp.where(is_data, run_id, jnp.int32(2**31 - 1)), reverse=True
    )
    return ((fwd == run_id) | (bwd == run_id)), ~valid_inv


@jax.jit
def _count_hits_kernel(data, queries):
    """Number of (valid) query rows present in sorted `data`, via a sort-join:
    cost is ONE sort of C+Q regardless of Q, with no per-query random
    access.  The data/query tag rides along as a
    PAYLOAD column (not a sort key): the segmented broadcast finds the data
    row anywhere in its run, so the comparator stays L keys wide.
    """
    L = data.shape[-1]
    rows = jnp.concatenate([data, queries], axis=0)
    tag = jnp.concatenate(
        [
            jnp.ones((data.shape[0],), jnp.uint32),
            jnp.zeros((queries.shape[0],), jnp.uint32),
        ]
    )
    ops = tuple(rows[:, l] for l in range(L)) + (tag,)
    sorted_ops = sort_cols(ops)
    is_data = sorted_ops[L] == 1
    has_data, valid = _sortjoin_hits(sorted_ops[:L], is_data)
    hits = (~is_data) & has_data & valid
    return jnp.sum(hits.astype(jnp.int32))


def _shift_tag(rows, tag: int):
    """Pack a 1-bit operand tag into the key's low bit: shift the whole
    multi-limb word left one bit (monotone: n_bits + 1 < 32L) and OR the
    tag into the last limb.  Sentinel rows stay all-ones: for L >= 2 the
    shift carries a 1 into limb 0's low bit from limb 1 (so limb 0 — the
    limb every consumer's sentinel test reads — stays 0xFFFFFFFF), but a
    1-LIMB word has no upper limb and would become 0xFFFFFFFE|tag, which
    tag-0 query pads then match against tag-0 data pads (counted every
    padded query as a hit at K=7-class configs); restore them
    explicitly."""
    L = rows.shape[-1]
    out = limbs.shift_left(rows, 1)
    if tag:
        out = out.at[:, L - 1].set(out[:, L - 1] | jnp.uint32(1))
    if L == 1:
        out = jnp.where(rows[:, :1] == _U32_MAX, _U32_MAX, out)
    return out


def _packed_join_count(s, L: int):
    """Hit count over packed-tag-sorted columns: query rows (tag 0) whose
    equal-WORD run contains a data row (tag 1).  With the packed tag, the
    data copies sort LAST in their run, so one reverse cummin over data
    run-ids finds them; sentinels (all-ones limb 0 — any valid shifted
    word's limb 0 is strictly smaller) are masked."""
    one = jnp.uint32(1)
    is_data = (s[L - 1] & one) == one
    valid = s[0] != _U32_MAX
    # run boundaries over the WORD (ignore the tag bit in the last limb)
    neq = (s[L - 1][1:] >> 1) != (s[L - 1][:-1] >> 1)
    for l in range(L - 1):
        neq = neq | (s[l][1:] != s[l][:-1])
    run_start = jnp.concatenate([jnp.ones((1,), dtype=bool), neq])
    run_id = jnp.cumsum(run_start.astype(jnp.int32))
    bwd = jax.lax.cummin(
        jnp.where(is_data, run_id, jnp.int32(2**31 - 1)), reverse=True
    )
    hits = (~is_data) & (bwd == run_id) & valid
    return jnp.sum(hits.astype(jnp.int32))


@jax.jit
def _count_hits_kernel_packed(data, queries):
    """Counting sort-join with the data/query tag PACKED into the key's low
    bit (rows shifted left one bit; data rows get tag 1).  The sort then
    moves L columns instead of L+1 — a third less HBM traffic for 2-limb
    words in the single most expensive kernel of the query path.  Requires
    n_bits + 1 <= 32*L - 1 (caller checks; true for every minimal-limb
    config except exact-multiple widths, which fall back to the payload-tag
    kernel above)."""
    L = data.shape[-1]
    rows = jnp.concatenate([_shift_tag(data, 1), _shift_tag(queries, 0)],
                           axis=0)
    s = sort_cols(tuple(rows[:, l] for l in range(L)))
    return _packed_join_count(s, L)


@jax.jit
def _count_hits_merge_kernel(data, queries):
    """`_count_hits_kernel_packed` exploiting the index's sort order: sort
    only the QUERIES, then one merge of the two sorted runs (one pass
    instead of the monolithic tagged sort — the main win of keeping the
    index sorted).
    Requires `data` sorted ascending and contiguous (duplicate rows fine,
    NO holes) — the caller dispatches on the holes flag."""
    L = data.shape[-1]
    d = _shift_tag(data, 1)  # monotone: data stays sorted after the shift
    q = _shift_tag(queries, 0)
    s = merge_with_unsorted(
        tuple(d[:, l] for l in range(L)),
        tuple(q[:, l] for l in range(L)),
    )
    return _packed_join_count(s, L)


@jax.jit
def _count_hits_merge_sorted_kernel(data, sorted_queries):
    """`_count_hits_merge_kernel` when the QUERY side is ALREADY sorted
    (e.g. a PackedStream words-memo populated by a build slab caches the
    fused build's sorted rows): no query sort at all — one merge
    pass of the two sorted runs + the packed-join scan.  The packed tag
    bit makes every key distinct (data copies sort after query copies of
    the same word), so no tie convention is needed from the merge."""
    L = data.shape[-1]
    d = _shift_tag(data, 1)
    q = _shift_tag(sorted_queries, 0)
    s = merge_sorted_pair(
        tuple(d[:, l] for l in range(L)),
        tuple(q[:, l] for l in range(L)),
    )
    return _packed_join_count(s, L)


@jax.jit
def _contains_sortjoin_kernel(data, queries):
    """Ordered membership via sort-join.

    Like `_count_hits_kernel` but carries each query's original position as
    the (single) payload column — data rows carry position Q, which doubles
    as the data tag.  One L-key sort of C+Q, then a cheap 1-key un-sort.
    Wins over the radix-window path for large query batches."""
    L = data.shape[-1]
    Q = queries.shape[0]
    rows = jnp.concatenate([data, queries], axis=0)
    idx = jnp.concatenate(
        [
            jnp.full((data.shape[0],), Q, dtype=jnp.int32),  # data tag
            jnp.arange(Q, dtype=jnp.int32),
        ]
    )
    ops = tuple(rows[:, l] for l in range(L)) + (idx,)
    sorted_ops = sort_cols(ops)
    qidx = sorted_ops[L]
    is_data = qidx == Q
    has_data, valid = _sortjoin_hits(sorted_ops[:L], is_data)
    hits = (~is_data) & has_data & valid
    # un-sort by a cheap 1-key sort on the position payload (data rows carry
    # position Q and fall off the end) — scatters would cost O(C+Q) updates
    _, ordered = sort_cols((qidx, hits.astype(jnp.uint32)))
    return ordered[:Q].astype(bool)


_SORTJOIN_MIN_QUERIES = 1 << 17


@jax.jit
def _searchsorted_kernel(data, queries):
    """Lower-bound index of each query row in sorted `data`.

    Vectorized binary search with limb-lexicographic compare; replaces the
    reference's Fenwick rank + bucket scan (`src/wordset/mod.rs:87-95`)."""
    C = data.shape[0]
    n_iter = max(C.bit_length(), 1)

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) >> 1
        rows = data[mid]
        less = limbs.lt(rows, queries)
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
        return lo, hi

    # derive the carry from `queries` so it inherits any mesh-axis-varying
    # type when called inside shard_map (a plain jnp.zeros carry would be
    # replicated and trip the scan carry-type check)
    lo = (queries[:, 0] * 0).astype(jnp.int32)
    hi = lo + C
    lo, hi = jax.lax.fori_loop(0, n_iter, body, (lo, hi))
    return lo


@jax.jit
def _contains_kernel(data, queries):
    idx = _searchsorted_kernel(data, queries)
    C = data.shape[0]
    rows = data[jnp.clip(idx, 0, C - 1)]
    return (idx < C) & limbs.eq(rows, queries) & _valid_mask(queries)


DEFAULT_TABLE_BITS = 22


def _radix_of(rows, n_bits: int, table_bits: int):
    """Top `table_bits` bits of each word — the bucket key.  This is the
    direct-address analog of the reference's prefix bitvector + Fenwick rank
    (`cxx/rank_bv.h`): position in the sorted array IS the rank, and a dense
    offsets table replaces rank queries with one gather."""
    return limbs.extract_bits(rows, n_bits - table_bits, table_bits).astype(
        jnp.int32
    )


@partial(jax.jit, static_argnames=("n_bits", "table_bits"))
def _radix_offsets_kernel(data, n_bits: int, table_bits: int):
    """Sorted data -> (offsets [2^tb + 1] int32, max_bucket scalar)."""
    valid = _valid_mask(data)
    radix = _radix_of(data, n_bits, table_bits)
    cnt = jnp.zeros((1 << table_bits,), jnp.int32).at[
        jnp.where(valid, radix, 1 << table_bits)
    ].add(1, mode="drop")
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(cnt)]
    )
    return offsets, jnp.max(cnt)


@partial(jax.jit, static_argnames=("n_bits", "table_bits", "window"))
def _contains_bucket_kernel(data, offsets, queries, n_bits: int,
                            table_bits: int, window: int):
    """Membership via radix bucket + fixed-window scan: one offsets gather,
    one [P, window] row gather, vectorized compares.  Requires window >=
    max bucket size (caller tracks the tier)."""
    C = data.shape[0]
    radix = _radix_of(queries, n_bits, table_bits)
    lo = offsets[radix]
    hi = offsets[radix + 1]
    w = lo[:, None] + jnp.arange(window, dtype=jnp.int32)[None, :]
    rows = data[jnp.clip(w, 0, C - 1)]  # [P, window, L]
    hit = limbs.eq(rows, queries[:, None, :]) & (w < hi[:, None])
    return jnp.any(hit, axis=1) & _valid_mask(queries)











@partial(jax.jit, donate_argnums=(0,))
def _append_kernel(pending, words, offset):
    return jax.lax.dynamic_update_slice(pending, words, (offset, jnp.int32(0)))


@partial(jax.jit, static_argnames=("n", "tag"), donate_argnums=(0,))
def _append_tags_kernel(tags, offset, n: int, tag: int):
    seq = (jnp.arange(n, dtype=jnp.uint32) + 1 + offset.astype(jnp.uint32))
    return jax.lax.dynamic_update_slice(
        tags, (seq << 1) | jnp.uint32(tag), (offset,)
    )


@_donate_if_aliasable("out_cap")
def _fold_log_kernel(data, pending, tags, out_cap: int):
    """Fold a mixed insert/remove pending LOG into the sorted array with
    last-write-wins semantics (the batched analog of the reference's per-op
    dynamic updates, `/root/reference/src/wordset/mod.rs:97-137`).

    data: sorted rows (duplicates tolerated), implicit (seq=0, op=insert).
    pending: [P, L] appended rows; tags: [P] uint32 = (append_seq << 1) | op
    with op 1=insert, 0=remove (sentinel rows anywhere are ignored).

    One sort of C+P with an extra seq key: within each equal-word run the
    LAST row decides (kept iff its op is insert), which also dedups."""
    C, L = data.shape
    rows = jnp.concatenate([data, pending], axis=0)
    seqtag = jnp.concatenate(
        [jnp.ones((C,), jnp.uint32), tags]
    )
    ops = tuple(rows[:, l] for l in range(L)) + (seqtag,)
    s = sort_cols(ops)
    keep = _fold_keep_mask(s, L)
    return _compact_marked(s, keep, L, out_cap)


def _fold_keep_mask(s, L: int):
    """Last-write-wins keep mask over (word, seqtag)-sorted columns: the
    LAST row of each equal-word run decides (kept iff its op bit is
    insert), which also dedups; sentinel-word rows are dropped."""
    neq = s[0][1:] != s[0][:-1]
    valid_inv = s[0] == _U32_MAX
    for l in range(1, L):
        neq = neq | (s[l][1:] != s[l][:-1])
        valid_inv = valid_inv & (s[l] == _U32_MAX)
    last_of_run = jnp.concatenate([neq, jnp.ones((1,), dtype=bool)])
    return ~valid_inv & last_of_run & ((s[L] & jnp.uint32(1)) == 1)


def _compact_marked(s, keep, L: int, out_cap: int):
    """Mark non-kept rows as the sentinel, compact by one re-sort, and
    truncate/pad to out_cap.  Returns (out, kept count)."""
    out_rows = jnp.stack(s[:L], axis=-1)
    out_rows = jnp.where(keep[:, None], out_rows, _U32_MAX)
    out_rows = sort_rows(out_rows)
    total = out_rows.shape[0]
    if out_cap <= total:
        out = out_rows[:out_cap]
    else:
        pad = jnp.full((out_cap - total, L), _U32_MAX, dtype=jnp.uint32)
        out = jnp.concatenate([out_rows, pad], axis=0)
    return out, jnp.sum(keep.astype(jnp.int32))


@partial(jax.jit, static_argnames=("out_cap",))
def _fold_log_merge_kernel(data, pending, tags, out_cap: int):
    """`_fold_log_kernel` exploiting the index's sort order: sort only the
    (pending, tags) log by (word, seqtag), merge it with the data
    side (whose implicit seqtag 1 sorts before every log entry of the same
    word, so the data side is already (word, seqtag)-sorted), then the
    same last-write-wins fold.  Requires `data` contiguous (no holes)."""
    C, L = data.shape
    s = merge_with_unsorted(
        tuple(data[:, l] for l in range(L)) + (jnp.ones((C,), jnp.uint32),),
        tuple(pending[:, l] for l in range(L)) + (tags,),
    )
    keep = _fold_keep_mask(s, L)
    return _compact_marked(s, keep, L, out_cap)


def _log_join_count(s, L: int):
    """Hit count over (word, seqtag)-sorted columns of data ⊕ log ⊕ queries:
    a query row (seqtag MAX, sorts last in its word run) hits iff the
    latest log/data entry at-or-before it IN ITS OWN RUN has the insert
    bit.  Two prefix scans, no gathers (run starts are monotone)."""
    n = s[0].shape[0]
    neq = s[0][1:] != s[0][:-1]
    sentinel = s[0] == _U32_MAX
    for l in range(1, L):
        neq = neq | (s[l][1:] != s[l][:-1])
        sentinel = sentinel & (s[l] == _U32_MAX)
    run_start = jnp.concatenate([jnp.ones((1,), dtype=bool), neq])
    idx = jnp.arange(n, dtype=jnp.int32)
    my_start = jax.lax.cummax(jnp.where(run_start, idx, 0))
    is_entry = (s[L] != _U32_MAX) & ~sentinel
    packed = jnp.where(
        is_entry, (idx << 1) | (s[L] & jnp.uint32(1)).astype(jnp.int32), -1
    )
    last = jax.lax.cummax(packed)
    hit = (
        (s[L] == _U32_MAX)
        & ~sentinel
        & (last >= 0)
        & ((last >> 1) >= my_start)
        & ((last & 1) == 1)
    )
    return jnp.sum(hit.astype(jnp.int32))


@jax.jit
def _count_hits_log_kernel(data, pending, tags, queries):
    """Counting join against (data ⊕ pending log) WITHOUT folding: one sort
    of C+P+Q keyed by (word, seqtag); within each word run the entry with
    the highest sequence decides membership (data rows are implicit
    seq-1 inserts, query rows carry seq MAX so they sort last)."""
    C, L = data.shape
    P = pending.shape[0]
    Q = queries.shape[0]
    rows = jnp.concatenate([data, pending, queries], axis=0)
    seqtag = jnp.concatenate(
        [
            jnp.ones((C,), jnp.uint32),
            tags,
            jnp.full((Q,), _U32_MAX, jnp.uint32),
        ]
    )
    ops = tuple(rows[:, l] for l in range(L)) + (seqtag,)
    s = sort_cols(ops)
    return _log_join_count(s, L)


@jax.jit
def _count_hits_log_merge_kernel(data, pending, tags, queries):
    """`_count_hits_log_kernel` exploiting the index's sort order: sort
    only (log ⊕ queries) by (word, seqtag), merge with the data
    side (implicit seqtag 1 — already sorted), same scan logic.  Requires
    `data` contiguous (no holes)."""
    C, L = data.shape
    P = pending.shape[0]
    Q = queries.shape[0]
    rows_b = jnp.concatenate([pending, queries], axis=0)
    seq_b = jnp.concatenate([tags, jnp.full((Q,), _U32_MAX, jnp.uint32)])
    s = merge_with_unsorted(
        tuple(data[:, l] for l in range(L)) + (jnp.ones((C,), jnp.uint32),),
        tuple(rows_b[:, l] for l in range(L)) + (seq_b,),
    )
    return _log_join_count(s, L)


@jax.jit
def _pending_override_kernel(pending, tags, queries):
    """Per-query override from the unflushed pending log: (has [Q] bool,
    present [Q] bool) where `has` marks queries whose word appears in the
    log and `present` gives the LAST logged op for it (True = insert).

    One (P+Q) sort; the log entry with the highest sequence in each word run
    is located with two prefix scans (no gathers): run starts are monotone
    positions, so `cummax(entry ? idx : -1) >= my_run_start` tests whether
    the latest entry at-or-before me is in my own run.  Queries carry
    seq = MAX so they sort after every log entry of their word."""
    P, L = pending.shape
    Q = queries.shape[0]
    rows = jnp.concatenate([pending, queries], axis=0)
    seqtag = jnp.concatenate([tags, jnp.full((Q,), _U32_MAX, jnp.uint32)])
    qpos = jnp.concatenate(
        [jnp.full((P,), Q, jnp.int32), jnp.arange(Q, dtype=jnp.int32)]
    )
    ops = tuple(rows[:, l] for l in range(L)) + (seqtag, qpos)
    s = sort_cols(ops)
    neq = s[0][1:] != s[0][:-1]
    sentinel = s[0] == _U32_MAX
    for l in range(1, L):
        neq = neq | (s[l][1:] != s[l][:-1])
        sentinel = sentinel & (s[l] == _U32_MAX)
    run_start = jnp.concatenate([jnp.ones((1,), dtype=bool), neq])
    idx = jnp.arange(P + Q, dtype=jnp.int32)
    my_start = jax.lax.cummax(jnp.where(run_start, idx, 0))
    is_entry = (s[L] != _U32_MAX) & ~sentinel
    packed = jnp.where(
        is_entry, (idx << 1) | (s[L] & jnp.uint32(1)).astype(jnp.int32), -1
    )
    last = jax.lax.cummax(packed)
    has = (last >= 0) & ((last >> 1) >= my_start)
    present = has & ((last & 1) == 1)
    # restore query order: 1-key sort on the position payload
    _, has_o, present_o = sort_cols(
        (s[L + 1], has.astype(jnp.uint32), present.astype(jnp.uint32))
    )
    return has_o[:Q].astype(bool), present_o[:Q].astype(bool)


# --- sorted-log (slog) kernels: the interleaved-workload representation ---
#
# A slog is ONE (word, tag)-sorted column tuple (L word limbs + 1 tag
# column) holding the WHOLE set state: every insert, remove, and query of
# every dynamic round, plus the pre-existing index rows (tag 1).  Tags are
# (round_seq << 2) | type with type 1=insert, 2=query, 3=remove, so within
# each equal-word run rows sit in operation order and a round's queries
# sort after its inserts but before its removes — the reference's
# sequential per-op semantics (`/root/reference/src/wordset/mod.rs:97-137`)
# fall out of the sort order by construction.  Sentinel/blanked rows carry
# tag MAX.  Each round costs two small merge passes (combining the three
# pre-sorted streams) + ONE big merge pass into the log + one single-pass
# scan — the index is never re-sorted and never folded mid-workload.
# Query rows stay behind as inert ballast (type-2 rows are never entries);
# evicting them with a second per-round merge pass costs a pass over the
# whole log, so the ballast is instead bounded by `maybe_autofold_slog`, which also bounds
# memory and keeps the scan's (idx << 2) int32 marker far from overflow.
# The stored log lives in the 1/8-step `_quantize_cap` capacity family
# (trailing sentinel rows): <=12.5% padding and round programs are reused
# until capacity actually grows (bounded jit variants, not one compile
# per round).
#
# PACKED-TAG layout: when the word leaves >= 8 spare bits in its limbs
# (`slog_packed(cfg)` — true for the K=25 flagship, 56 of 64 bits), the
# tag rides IN the word: each row is (word << 8) | tag over the same L
# limbs, no separate tag column.  (word, tag) lexicographic order is the
# numeric order of the packed value, so every slog sort/merge/scan runs
# on L columns instead of L+1 — one third less memory traffic per round
# at L=2.  Sentinel rows stay all-ones exactly (their tag is
# forced to 0xFF).  The 8-bit tag caps round_seq at 62 (63 would pack a
# remove to the 0xFF sentinel); `dynamic_round` folds before the cap.  Configs without spare bits (K=59: 125
# of 128 bits) keep the separate tag column; every kernel below takes a
# static `pack` flag.


def slog_packed(cfg: CBLConfig) -> bool:
    """True when the packed-tag slog layout applies to this config."""
    if cfg.n_bits + 8 > 32 * cfg.word_limbs:
        return False
    if cfg.n_bits + 8 == 32 * cfg.word_limbs:
        # Fully-occupied packed rows (e.g. K=25: 56 word bits + 8 tag bits
        # = 64): the all-ones word with the 0xFF query tag would equal the
        # sentinel and be masked out of `_slog_join_count` — a false
        # negative.  Prove it unreachable: an all-ones word needs its pos
        # field = 2^pos_bits - 1, but pos < 2K and for odd K, 2K is never
        # a power of two, so 2^ceil(log2(2K)) - 1 >= 2K > max pos.
        assert (1 << cfg.pos_bits) - 1 >= 2 * cfg.k, cfg
    return True


# Rounds run with seq = _slog_seq + 1, so the cap must keep
# (cap << 2) | 3 = 251 strictly below the 0xFF sentinel tag — at 63 a
# remove in the 63rd consecutive round would pack to 0xFF and be treated
# as a sentinel (silently dropped).
_SLOG_SEQ_MAX = 62  # packed tag = (seq << 2) | typ must stay < 0xFF


def _shl8_or(rows_cols, tag):
    """Pack word limb columns: (word << 8) | tag, big-endian limbs.
    `tag` is a [n] uint32 (values < 256)."""
    L = len(rows_cols)
    out = []
    for l in range(L):
        v = rows_cols[l] << 8
        if l + 1 < L:
            v = v | (rows_cols[l + 1] >> 24)
        else:
            v = v | tag
        out.append(v)
    return tuple(out)


def _shr8(rows):
    """Unpack [n, L] packed rows back to word rows (drops the tag)."""
    L = rows.shape[-1]
    out = []
    for l in range(L):
        v = rows[:, l] >> 8
        if l > 0:
            v = v | (rows[:, l - 1] << 24)
        out.append(v)
    return jnp.stack(out, axis=-1)


def _slog_tag(s, L: int, pack: bool):
    return (s[L - 1] & jnp.uint32(0xFF)) if pack else s[L]


def _slog_tag_max(pack: bool):
    return jnp.uint32(0xFF) if pack else _U32_MAX


def _slog_scan(s, L: int, pack: bool = False):
    """Shared prefix scan over (word, tag)-sorted slog columns.  Returns
    (neq [n-1], sentinel [n], live_here [n]) where live_here[i] means: the
    latest insert/remove ENTRY at-or-before i within i's word run is an
    insert — i.e. the word is present for an observer sorted at position
    i.

    ONE cummax does both jobs: every run start or entry row carries a
    marker (idx << 2) | (entry ? 2 | insert_bit : 0); the running max is
    whichever of {latest run start, latest entry} is later, so bit 1
    says "an entry exists in my current run" and bit 0 its kind —
    a run-start row that is itself an entry just carries the entry bits."""
    n = s[0].shape[0]
    neq = None
    sentinel = None
    for l in range(L):
        a, b = s[l][1:], s[l][:-1]
        if pack and l == L - 1:  # mask the in-word tag for run grouping
            # (the last limb is ALSO limb 0 for 1-limb configs)
            a, b = a & ~jnp.uint32(0xFF), b & ~jnp.uint32(0xFF)
        d = a != b
        neq = d if neq is None else neq | d
        sv = s[l] == _U32_MAX
        sentinel = sv if sentinel is None else sentinel & sv
    run_start = jnp.concatenate([jnp.ones((1,), dtype=bool), neq])
    idx = jnp.arange(n, dtype=jnp.int32)
    tag = _slog_tag(s, L, pack)
    typ = tag & jnp.uint32(3)
    is_entry = ((typ == 1) | (typ == 3)) & (
        tag != _slog_tag_max(pack)
    ) & ~sentinel
    marker = jnp.where(
        run_start | is_entry,
        (idx << 2)
        | jnp.where(
            is_entry,
            jnp.int32(2) | (typ == 1).astype(jnp.int32),
            jnp.int32(0),
        ),
        jnp.int32(-1),
    )
    m = jax.lax.cummax(marker)
    live_here = ((m & 2) != 0) & ((m & 1) != 0)
    return neq, sentinel, live_here


def slog_counts(cols, qtag, pack: bool = False):
    """(hits, live) int32 scalars over slog columns: hits = rows with tag
    == qtag whose word is live at their position; live = distinct live
    words.  One `_slog_scan` (a cummax) serves both."""
    cols = tuple(cols)
    L = len(cols) if pack else len(cols) - 1
    neq, sentinel, live_here = _slog_scan(cols, L, pack)
    hit = (_slog_tag(cols, L, pack) == qtag) & ~sentinel & live_here
    run_end = jnp.concatenate([neq, jnp.ones((1,), dtype=bool)])
    live = run_end & ~sentinel & live_here
    return (
        jnp.sum(hit.astype(jnp.int32)),
        jnp.sum(live.astype(jnp.int32)),
    )


@partial(jax.jit, static_argnames=("pack",))
def _slog_count_kernel(cols, pack: bool = False):
    """Distinct live words of a slog: word runs whose LAST entry is an
    insert (evaluated at each run's final row)."""
    return slog_counts(cols, _slog_tag_max(pack), pack)[1]


@partial(jax.jit, static_argnames=("pack",))
def _slog_join_count(cols, queries, pack: bool = False):
    """Membership count of `queries` (unsorted [Q, L] word rows) against a
    slog without folding it: sort the queries (tag MAX — sorts after every
    log entry of its word), one merge pass, one scan."""
    L = queries.shape[-1]
    Q = queries.shape[0]
    qcols = tuple(queries[:, l] for l in range(L))
    if pack:
        qcols = _shl8_or(qcols, jnp.full((Q,), 0xFF, jnp.uint32))
    else:
        qcols = qcols + (jnp.full((Q,), _U32_MAX, jnp.uint32),)
    s = merge_with_unsorted(cols, qcols)
    return slog_counts(s, _slog_tag_max(pack), pack)[0]


@partial(jax.jit, static_argnames=("out_cap", "pack"))
def _slog_fold_kernel(cols, out_cap: int, pack: bool = False):
    """Fold a slog to a clean sorted index: keep each live run's final row
    (its word, unpacked), mark everything else sentinel, one compaction
    sort."""
    L = len(cols) if pack else len(cols) - 1
    neq, sentinel, live_here = _slog_scan(cols, L, pack)
    run_end = jnp.concatenate([neq, jnp.ones((1,), dtype=bool)])
    keep = run_end & ~sentinel & live_here
    rows = jnp.stack(cols[:L], axis=1)
    if pack:
        rows = _shr8(rows)
    masked = jnp.where(keep[:, None], rows, _U32_MAX)
    return _compact_sort_kernel(masked, out_cap)


@partial(jax.jit, static_argnames=("pack",))
def _data_to_slog_cols(rows, pack: bool = False):
    """Turn a sorted index array into slog A-side columns: valid rows are
    implicit seq-0 inserts (tag 1), sentinel rows stay all-ones.  Packed
    layout shifts the tag into the word; unpacked appends a tag column."""
    L = rows.shape[-1]
    sent = rows[:, 0] == _U32_MAX
    for l in range(1, L):
        sent = sent & (rows[:, l] == _U32_MAX)
    cols = tuple(rows[:, l] for l in range(L))
    if pack:
        tag = jnp.where(sent, jnp.uint32(0xFF), jnp.uint32(1))
        return _shl8_or(cols, tag)
    return cols + (jnp.where(sent, _U32_MAX, jnp.uint32(1)),)


class DeviceWordSet:
    """A dynamic set of N_BITS-wide words as a sorted device array.

    API parity with `/root/reference/src/wordset/mod.rs`: count/is_empty/
    contains/insert/remove (batch-first; point ops are batches of 1),
    set algebra, iteration in ascending word order, prefix stats.
    """

    def __init__(self, cfg: CBLConfig, pending_cap: int = DEFAULT_PENDING_CAP):
        self.cfg = cfg
        self.L = cfg.word_limbs
        self.capacity = MIN_CAP
        # Exact count lives on device; the host tracks an upper bound so the
        # insert path never blocks on a device->host sync (capacity choices
        # only need the bound).  `self.n` syncs lazily.
        self._n_dev = None  # device scalar or None when exactly 0
        self._n_host: int | None = 0
        self._n_upper = 0
        # Invariant: data is sorted, duplicate-free, sentinel-padded, and its
        # length is the *live size* next_pow2(max(_n_upper, MIN_CAP)) — every
        # sort/join below costs O(live), never O(high-water capacity).
        # When `_holes` is True, sentinel rows may be interspersed (valid rows
        # still ascending and unique) and the array may be longer than the
        # live size; `_compact()` restores the contiguous invariant.
        self.data = jnp.full((self.capacity, self.L), _U32_MAX, dtype=jnp.uint32)
        self._holes = False
        # When `_dups` is True, `data` is sorted and contiguous but may hold
        # duplicate rows (the fused bulk-build keeps them to save one sort);
        # `_n_dev` still counts DISTINCT rows.  Membership queries and unions
        # are duplicate-tolerant; paths that are not call `_dedup()`.
        self._dups = False
        self.pending_cap = pending_cap
        self.n_pending = 0
        self.pending = jnp.full((pending_cap, self.L), _U32_MAX, dtype=jnp.uint32)
        # pending LOG metadata: (seq << 1) | op per appended row (op 1=insert,
        # 0=remove); removes stay in the log until a fold — a remove is an
        # O(append) operation, not a full-index sort
        # (`/root/reference/src/wordset/mod.rs:97-137` dynamic contract)
        self.pending_tags = jnp.zeros((pending_cap,), dtype=jnp.uint32)
        self._pending_rm = False
        # radix lookup acceleration (rebuilt lazily after each mutation)
        self.table_bits = min(DEFAULT_TABLE_BITS, cfg.n_bits)
        self._offsets = None
        self._window = 8
        # sorted-log state (interleaved dynamic rounds; see module kernels):
        # when active, `_slog` REPLACES `data` as the set representation
        # (data was merged into it on entry) until `_fold_slog` runs.
        self._slog: tuple | None = None
        self._slog_seq = 0
        self._slog_count_dev = None
        # upper bound on NON-sentinel rows in the slog (host-side, never
        # synced): capacity/truncation choices and the auto-fold policy
        # depend only on this bound
        self._slog_real = 0
        # packed-tag layout (tag inside the word limbs) when the config
        # leaves >= 8 spare bits — see the slog kernel block above
        self._slog_pack = slog_packed(cfg)

    @property
    def n(self) -> int:
        """Exact element count (forces a device sync if one is pending)."""
        if self._n_host is None:
            self._n_host = int(self._n_dev)
            if not self._dups:
                # n counts DISTINCT rows; with duplicates retained the
                # valid prefix can exceed it, so only a dup-free array may
                # tighten the live-size bound to it
                self._n_upper = self._n_host
        return self._n_host

    def _live(self, floor: int = 1):
        """The prefix of `data` that can hold every valid row — all sorts,
        joins, and merges run over this slice so their cost tracks the actual
        content, not the allocation.  With holes the whole array is live."""
        if self._holes:
            return self.data
        eff = min(self.data.shape[0], max(_next_pow2(max(self._n_upper, 1)), floor))
        return self.data if eff >= self.data.shape[0] else self.data[:eff]

    def _compact(self) -> None:
        """Restore the contiguous sorted invariant (one sort)."""
        if not self._holes:
            return
        out_cap = max(_next_pow2(max(self._n_upper, 1)), MIN_CAP)
        self.data, n_dev = _compact_sort_kernel(self.data, out_cap)
        self.capacity = out_cap
        self._holes = False
        self._set_count(n_dev)
        self._invalidate_index()

    def _dedup(self) -> None:
        """Physically drop duplicate rows left by a fused bulk build (one
        sort).  Required before intersection/symmetric-difference adjacency
        logic and before export/iteration."""
        if not self._dups:
            return
        self.flush()
        n = self.n  # device sync: exact distinct count sizes the result
        out_cap = max(_next_pow2(max(n, 1)), MIN_CAP)
        self.data, n_dev = _dedup_sorted_kernel(self._live(), out_cap)
        self.capacity = out_cap
        self._dups = False
        self._holes = False
        self._set_count(n_dev)
        self._n_upper = n
        self._invalidate_index()

    def adopt_built(self, data, n_dev, n_upper: int) -> None:
        """Take ownership of a fused-build result: `data` sorted ascending,
        valid rows first (duplicates allowed), sentinel-padded to a
        power-of-two length; `n_dev` = device scalar of DISTINCT rows."""
        assert self._slog is None and self.n == 0 and self.n_pending == 0
        self.data = data
        self.capacity = data.shape[0]
        self._holes = False
        self._dups = True
        self._set_count(n_dev)
        self._n_upper = min(n_upper, self.capacity)
        self._invalidate_index()

    # --- insert path ---

    def insert_words(self, words) -> None:
        """Queue [N, L] word rows (sentinel rows are ignored at flush)."""
        self._append_log(words, tag=1)

    def _append_log(self, words, tag: int) -> None:
        n = words.shape[0]
        if n > self.pending_cap:
            self.flush()
            if tag == 1:
                self._merge_into(words, n_new_upper=n)
            else:
                self._remove_now(words)
            return
        if self.n_pending + n > self.pending_cap:
            self.flush()
        if tag == 0:
            self._pending_rm = True
        self.pending_tags = _append_tags_kernel(
            self.pending_tags, jnp.int32(self.n_pending), n, tag
        )
        self.pending = _append_kernel(self.pending, words, jnp.int32(self.n_pending))
        self.n_pending += n

    def insert_rows_bulk(self, rows_list: list) -> None:
        """Fold a whole stream's word batches in ONE merge: concat + sort +
        dedup + resort.  For a build-from-scratch this is 2 sorts of ~N total,
        vs a ladder of per-flush merges each sorting the whole index again —
        the difference between O(N log N) and O(N^2 / pending_cap) HBM work."""
        if not rows_list:
            return
        self.flush()
        rows = rows_list[0] if len(rows_list) == 1 else jnp.concatenate(rows_list)
        self._merge_into(rows, n_new_upper=rows.shape[0])

    def flush(self) -> None:
        """Fold the pending buffer into the sorted array.

        Only the next-power-of-two prefix of the buffer is merged, so a
        lightly-filled buffer costs a small sort (shape variants stay
        log-bounded for the jit cache)."""
        self._fold_slog()
        if self.n_pending == 0:
            return
        n_pend = self.n_pending
        eff = min(_next_pow2(n_pend), self.pending_cap)
        rows = self.pending[:eff]
        tags = self.pending_tags[:eff]
        had_rm = self._pending_rm
        self.pending = jnp.full(
            (self.pending_cap, self.L), _U32_MAX, dtype=jnp.uint32
        )
        self.pending_tags = jnp.zeros((self.pending_cap,), dtype=jnp.uint32)
        self.n_pending = 0
        self._pending_rm = False
        if not had_rm:
            self._merge_into(rows, n_new_upper=n_pend)
            return
        # mixed insert/remove log: one last-write-wins fold sort (holes and
        # duplicate rows in `data` are both tolerated — everything re-sorts)
        out_cap = max(_next_pow2(self._n_upper + n_pend), MIN_CAP)
        data = (
            self.data[:0]
            if self._n_upper == 0 and not self._holes
            else self._live()
        )
        fold = (
            _fold_log_merge_kernel
            if not self._holes and data.shape[0]
            else _fold_log_kernel
        )
        self.data, n_dev = fold(data, rows, tags, out_cap)
        self.capacity = out_cap
        self._holes = False
        self._dups = False
        self._set_count(n_dev)
        self._n_upper = min(self._n_upper + n_pend, out_cap)
        self._invalidate_index()

    def _fold_slog(self) -> None:
        """Collapse an active sorted-log into a clean sorted `data` array
        (one compaction sort).  No-op when no slog is active."""
        if self._slog is None:
            return
        cols = self._slog
        self._slog = None
        self._slog_seq = 0
        self._slog_count_dev = None
        self._slog_real = 0
        out_cap = max(_next_pow2(max(self._n_upper, 1)), MIN_CAP)
        self.data, n_dev = _slog_fold_kernel(cols, out_cap, self._slog_pack)
        self.capacity = out_cap
        self._holes = False
        self._dups = False
        self._set_count(n_dev)
        self._invalidate_index()

    # auto-fold policy: the slog may hold dead rows (overwritten inserts,
    # removes, remove-of-absent) that every later merge and scan pays for.
    # Fold when the log's real-row bound exceeds FOLD_MULT x the live-set
    # pow2 bound (so fold cost amortises against the work it saves), or
    # when the next rounds would push the scan marker (idx << 2, int32 —
    # see _slog_scan) toward overflow.
    _SLOG_FOLD_MULT = 4
    _SLOG_HARD_CAP = 1 << 27

    def maybe_autofold_slog(self) -> None:
        if self._slog is None:
            return
        live_cap = max(_next_pow2(max(self._n_upper, 1)), MIN_CAP)
        if (
            self._slog_real > self._SLOG_FOLD_MULT * live_cap
            or self._slog_real > self._SLOG_HARD_CAP
        ):
            self._fold_slog()
            # one scalar sync tightens _n_upper to the exact live count
            # (fold output is duplicate-free), making the bound above
            # live-proportional instead of cumulative-insert-proportional;
            # folds are rare so the sync amortises
            _ = self.n

    def _merge_into(self, rows, n_new_upper: int,
                    batch_sorted: bool = False) -> None:
        out_cap = max(_next_pow2(self._n_upper + n_new_upper), MIN_CAP)
        # an empty index contributes ZERO rows (not a 1-row slice): keeps the
        # concat size a power of two so downstream compaction can donate its
        # buffer (odd sizes forced a silent whole-array copy)
        data = (
            self.data[:0]
            if self._n_upper == 0 and not self._holes
            else self._live()
        )
        if data.shape[0] == 0:
            # fresh index: one sort of the batch, duplicates kept
            if batch_sorted:
                self.data, n_dev = rows, _distinct_count(rows)
            else:
                self.data, n_dev = _build_sorted_kernel(rows)
            self.capacity = self.data.shape[0]
            self._dups = True
        elif self._holes:
            # non-monotone (holes) index: monolithic sort fallback
            self.data, n_dev = _merge_sortmark_kernel(data, rows)
            self.capacity = self.data.shape[0]
            self._holes = True
            self._dups = False
        elif data.shape[0] + rows.shape[0] <= 2 * out_cap:
            # sorted index: sort only the batch + one merge; duplicate
            # rows are kept (the array stays monotone; see kernel docstring)
            kern = (
                _merge_sortedbatch_kernel if batch_sorted
                else _merge_keepdups_kernel
            )
            self.data, n_dev = kern(data, rows)
            self.capacity = self.data.shape[0]
            self._dups = True
        else:
            # dup/pad fraction would exceed ~1/2: fold the compaction into
            # this merge (two sorts) and reset the array to the live size
            self.data, n_dev = _merge_sortcompact_kernel(data, rows, out_cap)
            self.capacity = out_cap
            self._holes = False
            self._dups = False
        self._invalidate_index()
        self._n_dev = n_dev
        self._n_host = None  # sync lazily
        self._n_upper = min(self._n_upper + n_new_upper, out_cap)

    def _set_count(self, n_dev) -> None:
        self._n_dev = n_dev
        self._n_host = None
        self._n_upper = min(self._n_upper, self.capacity)

    # --- queries / removal ---

    def count_hits(self, words) -> int:
        """Number of stored words among `words` (sentinel rows ignored) —
        the counting query path (CLI query / contains_all).

        A contiguous index joins by one merge with the sorted queries; one
        with holes by a packed-tag sort-join of C+Q, which tolerates holes
        and duplicate rows, so no compaction is ever forced."""
        return int(self.count_hits_device(words))

    def count_hits_device(self, words):
        """`count_hits` as an unsynced device scalar.  A non-empty pending
        LOG joins in the same sort (data ⊕ log last-write-wins) — queries
        never force a fold; the log folds only on buffer overflow or
        count()."""
        if self._slog is not None:
            if self.n_pending > 0:
                self._fold_slog()  # rare mixed-API interleaving
            else:
                return _slog_join_count(self._slog, words, self._slog_pack)
        if self.n_pending > 0:
            eff = min(_next_pow2(self.n_pending), self.pending_cap)
            live = self._live()
            log_join = (
                _count_hits_log_merge_kernel
                if not self._holes and live.shape[0]
                else _count_hits_log_kernel
            )
            return log_join(
                live, self.pending[:eff], self.pending_tags[:eff], words
            )
        if self.cfg.n_bits <= 32 * self.L - 2:
            if not self._holes:
                return _count_hits_merge_kernel(self._live(), words)
            return _count_hits_kernel_packed(self._live(), words)
        return _count_hits_kernel(self._live(), words)

    def _invalidate_index(self) -> None:
        self._offsets = None

    def _ensure_radix_index(self) -> bool:
        """Build the offsets table if stale; returns False when the bucket
        path shouldn't be used (giant buckets -> binary search fallback)."""
        import os

        if os.environ.get("CBL_TPU_NO_RADIX"):
            return False
        if self._offsets is None:
            self._offsets, mb = _radix_offsets_kernel(
                self._live(), self.cfg.n_bits, self.table_bits
            )
            mb = max(int(mb), 1)
            self._window = max(_next_pow2(mb), 8)
        return self._window <= 1024

    def contains_words(self, words):
        """[N] bool device array; sentinel query rows -> False.

        With a non-empty pending log the base answer from the sorted array
        is OVERRIDDEN by the log's last op per word — point/interleaved
        queries never force a fold (reference dynamic-op cost contract,
        `/root/reference/src/wordset/mod.rs:87-137`)."""
        if self._slog is not None:
            self._fold_slog()
        override = None
        if self.n_pending > 0:
            eff = min(_next_pow2(self.n_pending), self.pending_cap)
            override = _pending_override_kernel(
                self.pending[:eff], self.pending_tags[:eff], words
            )
        base = self._contains_base(words)
        if override is None:
            return base
        has, present = override
        return jnp.where(has, present, base) & _valid_mask(words)

    def _contains_base(self, words):
        if words.shape[0] >= _SORTJOIN_MIN_QUERIES:
            return _contains_sortjoin_kernel(self._live(), words)
        self._compact()  # radix windows / binary search need contiguity
        if self._ensure_radix_index():
            return _contains_bucket_kernel(
                self._live(),
                self._offsets,
                words,
                self.cfg.n_bits,
                self.table_bits,
                self._window,
            )
        return _contains_kernel(self._live(), words)

    def remove_words(self, words) -> None:
        """Queue [N, L] word removals (lazy: folds with the pending log)."""
        self._append_log(words, tag=0)

    def _remove_now(self, words) -> None:
        """Immediate removal set-op (oversized batches only)."""
        data = self._live()
        out_cap = max(_next_pow2(max(self._n_upper, 1)), MIN_CAP)
        self.data, n_dev = _setop_kernel_for(self.cfg)(
            data, words, "remove", out_cap
        )
        self.capacity = out_cap
        self._holes = False  # set-op kernels re-sort and compact
        self._dups = False  # remove keeps the first row of each equal run
        self._set_count(n_dev)
        self._invalidate_index()

    def count(self) -> int:
        if self._slog is not None and self.n_pending == 0:
            return int(self._slog_count())
        self.flush()
        return self.n

    def _slog_count(self):
        if self._slog_count_dev is None:
            self._slog_count_dev = _slog_count_kernel(
                self._slog, self._slog_pack
            )
        return self._slog_count_dev

    def count_device(self):
        """Exact distinct count as an UNSYNCED device scalar (int32 0-d).
        Flushes the pending log (enqueues device work) but never blocks, so
        a caller can batch several scalars into one device_get.  An active
        slog is counted by scan, not folded."""
        if self._slog is not None and self.n_pending == 0:
            return self._slog_count()
        self.flush()
        return jnp.int32(0) if self._n_dev is None else self._n_dev

    def is_empty(self) -> bool:
        return self.count() == 0

    # --- set algebra (`/root/reference/src/wordset/set_ops.rs`) ---

    def _binary_out_cap(self, other: "DeviceWordSet", upper: int) -> int:
        return max(MIN_CAP, _next_pow2(upper))

    def _live_copy(self):
        """Live slice safe to pass to a donating kernel (operands of set ops
        must survive; the reference's set ops don't consume,
        `src/wordset/set_ops.rs:78-410`)."""
        d = self._live()
        return d + jnp.uint32(0) if d is self.data else d

    def _merge_setop_ready(self, other: "DeviceWordSet") -> bool:
        """Both operands contiguous (sentinels only at the tail) and the
        one-pass merge path engaged: set ops skip the full tagged re-sort
        and run ONE streamed merge + adjacency marks."""
        n_total = self._live().shape[0] + other._live().shape[0]
        if not use_merge_kernel(n_total):
            return False
        self._compact()
        other._compact()
        return True

    def union(self, other: "DeviceWordSet") -> "DeviceWordSet":
        self.flush()
        other.flush()
        out = DeviceWordSet(self.cfg, self.pending_cap)
        if self._merge_setop_ready(other):
            data, n_dev = _union_merge_kernel(self._live(), other._live())
            out.data, out.capacity = data, data.shape[0]
            out._n_upper = data.shape[0]
            out._dups = True  # duplicate word copies retained; dedup lazy
            out._set_count(n_dev)
            return out
        cap = self._binary_out_cap(other, self.n + other.n)
        data, n_dev = _merge_sortcompact_kernel(
            self._live_copy(), other._live(), cap
        )
        out.data, out.capacity = data, cap
        out._n_upper = cap
        out._set_count(n_dev)
        return out

    def _marking_setop(self, other: "DeviceWordSet", op: str,
                       cap_bound: int) -> "DeviceWordSet":
        out = DeviceWordSet(self.cfg, self.pending_cap)
        if (
            self.cfg.n_bits <= 32 * self.L - 2
            and self._merge_setop_ready(other)
        ):
            data, n_dev = _setop_merge_kernel(
                self._live(), other._live(), op
            )
            out.data, out.capacity = data, data.shape[0]
            out._n_upper = min(cap_bound, data.shape[0])
            out._holes = True  # non-kept rows blanked in place; compact lazy
            out._set_count(n_dev)
            return out
        cap = self._binary_out_cap(other, cap_bound)
        data, n_dev = _setop_kernel_for(self.cfg)(
            self._live_copy(), other._live(), op, cap
        )
        out.data, out.capacity = data, cap
        out._n_upper = cap
        out._set_count(n_dev)
        return out

    def intersection(self, other: "DeviceWordSet") -> "DeviceWordSet":
        self.flush()
        other.flush()
        self._dedup()
        other._dedup()
        return self._marking_setop(other, "inter", min(self.n, other.n))

    def difference(self, other: "DeviceWordSet") -> "DeviceWordSet":
        self.flush()
        other.flush()
        return self._marking_setop(other, "diff", self.n)

    def symmetric_difference(self, other: "DeviceWordSet") -> "DeviceWordSet":
        self.flush()
        other.flush()
        self._dedup()
        other._dedup()
        return self._marking_setop(other, "symdiff", self.n + other.n)

    @staticmethod
    def merge_many(sets: list["DeviceWordSet"]) -> "DeviceWordSet":
        """k-way union in ONE sort+dedup pass over all operands —
        the vectorized analog of the reference's k-way heap merge
        (`/root/reference/src/wordset/set_ops.rs:11-42`)."""
        assert sets
        if len(sets) == 1:
            return sets[0].copy()
        for s in sets:
            s.flush()
        total = sum(s.n for s in sets)
        cap = max(MIN_CAP, _next_pow2(total))
        cat = jnp.concatenate([s._live() for s in sets], axis=0)
        out = DeviceWordSet(sets[0].cfg, sets[0].pending_cap)
        data, n_dev = _merge_sortcompact_kernel(cat, cat[:0], cap)
        out.data, out.capacity = data, cap
        out._n_upper = cap
        out._set_count(n_dev)
        return out

    @staticmethod
    def intersect_many(sets: list["DeviceWordSet"]) -> "DeviceWordSet":
        """k-way intersection; `/root/reference/src/wordset/set_ops.rs:44-76`."""
        assert sets
        out = (
            sets[0].intersection(sets[1]) if len(sets) > 1 else sets[0].copy()
        )
        for s in sets[2:]:
            out = out.intersection(s)
        return out

    def copy(self) -> "DeviceWordSet":
        self.flush()
        out = DeviceWordSet(self.cfg, self.pending_cap)
        out.data = self._live_copy()
        out.capacity = out.data.shape[0]
        out._holes = self._holes
        out._dups = self._dups
        out._n_host = self.n
        out._n_upper = max(self.n, self._n_upper if self._dups else 0)
        return out

    # --- iteration / export ---

    def words_array(self) -> np.ndarray:
        """[n, L] uint32 host array in ascending word order."""
        self.flush()
        self._compact()
        self._dedup()
        # transfer the whole (pow2) array and slice on host: a device-side
        # [:n] slice compiles a fresh one-off-shape program per distinct n
        return np.asarray(self.data)[: self.n]

    def iter_words_chunks(self, chunk_rows: int = 1 << 22):
        """Yield [<=chunk_rows, L] host arrays in ascending word order
        WITHOUT materialising the whole index on host — the bounded-memory
        analog of the reference's lazy iteration
        (`/root/reference/src/wordset/mod.rs:298-362`).  At K=59 scale a
        full `words_array` doubles peak host memory; chunked transfers
        bound it.
        Chunks use a fixed-size dynamic slice (one compiled program per
        (capacity, chunk) pair, start index traced)."""
        self.flush()
        self._compact()
        self._dedup()
        n = self.n
        if n == 0:
            return
        cap = self.data.shape[0]
        if cap <= chunk_rows or n <= chunk_rows:
            yield np.asarray(self.data)[:n]
            return
        slicer = _chunk_slice_fn(cap, chunk_rows)
        emitted = 0
        while emitted < n:
            # clamp so the slice stays in-bounds; re-emit the overlap-free
            # tail of the final (clamped) block
            start = min(emitted, cap - chunk_rows)
            block = np.asarray(slicer(self.data, np.int32(start)))
            lo = emitted - start
            take = min(chunk_rows - lo, n - emitted)
            yield block[lo : lo + take]
            emitted += take

    def prefixes(self) -> np.ndarray:
        """Sorted [n] uint32 prefix of each stored word."""
        from . import necklace

        self.flush()
        self._compact()
        self._dedup()
        if self.n == 0:
            return np.zeros((0,), dtype=np.uint32)
        # full-array kernel + host slice (avoids per-n device slice programs)
        return np.asarray(necklace.word_prefix(self.data, self.cfg))[: self.n]
