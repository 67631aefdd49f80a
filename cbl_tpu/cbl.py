"""CBL — the public k-mer set API.

Parity target: `/root/reference/src/cbl.rs` (struct `CBL<K, T, PREFIX_BITS>`,
`:41-54`).  Semantics preserved exactly:

- k-mer -> (canonical form if canonical mode) -> necklace + rotation pos ->
  packed word -> set membership (`src/cbl.rs:199-206`).
- sequences: every k-mer of the ACGT-filtered sequence (invalid bytes are
  skipped as in `src/kmer.rs:131-135`); k-mers never span record boundaries.
- canonical mode: K odd, canonical = even popcount (`src/kmer.rs:93-97`).

Pipeline design (replaces `src/cbl.rs:239-289`): the base stream is packed
16 bases/uint32, chunked into fixed-size windows with K-1 overlap (the
reference's own halo pattern, CHUNK_SIZE=2048 at `src/cbl.rs:67`; ours is
larger to fill the device), and each chunk runs one jitted program:
extract -> canonicalize -> necklace -> pack -> (query | queue for merge).

Divergences (documented, CLI-observable behavior preserved):
- `contains_seq` returns results in *sequence order* in canonical mode; the
  reference emits forward-canonical results before reverse-complement ones
  within each 2048-chunk (`src/cbl.rs:249-274`) — its own CLI only counts
  positives (`examples/cbl.rs:214-223`), which is order-insensitive.
- iteration is in ascending packed-word order (prefix-major, sorted
  suffixes); reference vec-buckets iterate in insertion order
  (`src/wordset/mod.rs:349-361`) and its tests sort before comparing
  (`src/cbl.rs:763-773`).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from . import kmer as kmod
from . import limbs, necklace
from .config import CBLConfig, get_config
from .wordset import _SLOG_SEQ_MAX, DeviceWordSet

DEFAULT_CHUNK = 1 << 19  # k-mers per device program
_U32_MAX = np.uint32(0xFFFFFFFF)


def _stream_len(chunk: int, k: int) -> int:
    """Padded base-stream length per chunk (multiple of 16)."""
    raw = chunk + k - 1
    return (raw + 15) // 16 * 16


@lru_cache(maxsize=None)
def _pipeline_fn(cfg: CBLConfig, canonical: bool, chunk: int):
    """stream [S/16] uint32 (16 packed bases/word), validbits [chunk/8] uint8
    (np.packbits) -> words [chunk, L] (invalid rows = sentinel).  One fused
    XLA program per (config, mode, chunk); inputs are bit-packed host-side to
    minimise host->device transfer."""

    def run(stream, validbits):
        kmers = kmod.extract_kmers(stream, chunk, cfg)
        if canonical:
            kmers, _ = kmod.canonicalize(kmers, cfg)
        best, pos = necklace.necklace_pos(kmers, cfg)
        words = necklace.pack_word(best, pos, cfg)
        valid = (
            (validbits[:, None] >> jnp.arange(7, -1, -1, dtype=jnp.uint8))
            & jnp.uint8(1)
        ).astype(bool).reshape(-1)
        return jnp.where(valid[:, None], words, _U32_MAX)

    return jax.jit(run)


# --- fused whole-stream path -------------------------------------------------
#
# The chunked pipeline above pays one device dispatch per chunk.  The fused
# path runs the ENTIRE stream slab (up to 2^25 k-mers) as ONE XLA
# program: extract -> (canonicalize) -> necklace -> pack -> record-boundary
# blanking -> sort (+ distinct count) for builds, or -> join for queries.
# The valid mask is computed ON DEVICE from blank intervals (host transfers
# only the packed 2-bit stream + interval endpoints, not per-k-mer masks).

_FUSED_SLAB = 1 << 25  # max k-mers per fused device program


def _device_words(stream, starts, ends, nk_pad: int, cfg: CBLConfig,
                  canonical: bool):
    """On-device pipeline: packed stream -> ([nk_pad, L] packed words with
    blanked rows = sentinel, n_valid scalar).

    starts/ends: int32 interval endpoints of INVALID k-mer start positions
    (record-boundary halos per `/root/reference/src/cbl.rs:239-243` semantics,
    short trailing records, and the padded tail); rows covered by at least
    one interval are blanked.  Padding entries use index nk_pad + 1 (dropped).
    """
    kmers = kmod.extract_kmers(stream, nk_pad, cfg)
    if canonical:
        kmers, _ = kmod.canonicalize(kmers, cfg)
    best, pos = necklace.necklace_pos(kmers, cfg)
    words = necklace.pack_word(best, pos, cfg)
    blanked, n_valid = _blank_mask(starts, ends, nk_pad)
    return jnp.where(blanked[:, None], _U32_MAX, words), n_valid


def _blank_mask(starts, ends, nk_pad: int):
    """([nk_pad] bool, n_valid): rows covered by at least one [start, end)
    interval, as the running sum of +1/-1 interval deltas; indices past
    nk_pad are dropped."""
    delta = (
        jnp.zeros((nk_pad + 1,), jnp.int32)
        .at[starts].add(1, mode="drop")
        .at[ends].add(-1, mode="drop")
    )
    blanked = jnp.cumsum(delta)[:nk_pad] > 0
    return blanked, jnp.sum((~blanked).astype(jnp.int32))


@lru_cache(maxsize=None)
def _fused_build_fn(cfg: CBLConfig, canonical: bool, nk_pad: int):
    """(stream, starts, ends) -> (sorted words [nk_pad, L], n_distinct,
    n_valid).

    The output keeps duplicate rows (sorted ascending, sentinels last) —
    one sort instead of two; `DeviceWordSet.adopt_built` tracks the `_dups`
    flag and dedups lazily when an op needs uniqueness."""
    from .wordset import sort_rows, _valid_mask

    def run(stream, starts, ends):
        words, n_valid = _device_words(stream, starts, ends, nk_pad, cfg,
                                       canonical)
        s = sort_rows(words)
        prev_eq = jnp.concatenate(
            [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
        )
        distinct = _valid_mask(s) & ~prev_eq
        return s, jnp.sum(distinct.astype(jnp.int32)), n_valid

    return jax.jit(run)


@lru_cache(maxsize=None)
def _fused_words_fn(cfg: CBLConfig, canonical: bool, nk_pad: int):
    """(stream, starts, ends) -> (words [nk_pad, L] unsorted, n_valid)."""

    def run(stream, starts, ends):
        return _device_words(stream, starts, ends, nk_pad, cfg, canonical)

    return jax.jit(run)


@lru_cache(maxsize=None)
def _fused_words_sorted_fn(cfg: CBLConfig, canonical: bool, nk_pad: int):
    """(stream, starts, ends) -> (words [nk_pad, L] SORTED, n_valid): the
    insert-path variant of `_fused_words_fn` — sorting inside the fused
    program costs exactly what the downstream merge kernel would pay
    anyway, and the sorted rows are reusable by later merge-joins (the
    words-memo sorted flag)."""
    from .wordset import sort_rows

    def run(stream, starts, ends):
        words, n_valid = _device_words(stream, starts, ends, nk_pad, cfg,
                                       canonical)
        return sort_rows(words), n_valid

    return jax.jit(run)


@lru_cache(maxsize=None)
def _fused_query_fn(cfg: CBLConfig, canonical: bool, nk_pad: int,
                    holes: bool = False):
    """(stream, starts, ends, data) -> (total, positive) device scalars.

    With a contiguous sorted index (holes=False, the common case) the join
    sorts only the query side and MERGES it with the index
    (`_count_hits_merge_kernel`, one merge pass).  A holes index (sentinel
    rows interspersed by a deferred-compaction merge) is not monotone, so
    it falls back to the monolithic packed-tag sort of C+Q, which
    tolerates anything."""
    from .wordset import (
        _count_hits_kernel,
        _count_hits_kernel_packed,
        _count_hits_merge_kernel,
    )

    packed_ok = cfg.n_bits <= 32 * cfg.word_limbs - 2

    def run(stream, starts, ends, data):
        words, n_valid = _device_words(stream, starts, ends, nk_pad, cfg,
                                       canonical)
        if not packed_ok:
            positive = _count_hits_kernel(data, words)
        elif holes:
            positive = _count_hits_kernel_packed(data, words)
        else:
            positive = _count_hits_merge_kernel(data, words)
        return n_valid, positive

    return jax.jit(run)


@lru_cache(maxsize=None)
def _fused_contains_fn(cfg: CBLConfig, canonical: bool, nk_pad: int):
    """(stream, starts, ends, data) -> [nk_pad] bool mask in k-mer start
    order (blanked rows False) — the ordered-membership analog of
    `_fused_query_fn`: the whole record stream's masks come back in
    O(slabs) device programs instead of one dispatch per sequence
    (reference `contains_seq`, `/root/reference/src/cbl.rs:311-324`)."""
    from .wordset import _contains_sortjoin_kernel

    def run(stream, starts, ends, data):
        words, _ = _device_words(stream, starts, ends, nk_pad, cfg,
                                 canonical)
        return _contains_sortjoin_kernel(data, words)

    return jax.jit(run)


@lru_cache(maxsize=None)
def _fused_round_slog_fn(cfg: CBLConfig, nk_i: int, nk_q: int, nk_r: int,
                         a_cap: int, out_cap: int):
    """One interleaved dynamic round as a SINGLE device program over the
    SORTED-LOG representation (wordset.py slog kernels): take the three
    streams' PRE-SORTED word arrays (PackedStream memo — a re-used
    stream, e.g. querying what an earlier round inserted, never re-sorts
    and never re-runs the necklace pipeline), tag each with its constant
    (seq<<2 | {1=ins, 2=qry, 3=rm}), combine them with two small
    merges, merge the batch into the log with one big pass,
    and scan the result once for the round's query hits AND the set's
    distinct count.

    The tag sandwich makes the reference's sequential per-op semantics
    (`/root/reference/src/wordset/mod.rs:97-137`) a property of the sort
    order: a round's queries sort after its inserts but before its
    removes, and the scan only honours entries at-or-before each query.

    Design note: joining queries with a SECOND merge pass against the log
    — keeping them out of the stored state — costs a pass over the whole
    log, more than the ballast it avoids; so queries ride in the ONE batch merge and stay behind as
    inert rows until `maybe_autofold_slog` strips them.  The log lives
    in a 1/8-step quantized capacity family (`_quantize_cap`): <=12.5%
    sentinel padding, bounded compile variants, and truncation only ever
    drops all-sentinel tail rows (the caller guarantees real <= out_cap).
    With the packed-tag layout (`wordset.slog_packed`, e.g. K=25) the tag
    rides inside the word limbs, so every pass below handles L columns
    instead of L+1 — one third less memory traffic at L=2.
    Returns (merged slog cols [out_cap], positive, live)."""
    from .wordset import _U32_MAX as _MAX
    from .wordset import _shl8_or, slog_counts, slog_packed
    from .ops.merge import merge_sorted_pair

    L = cfg.word_limbs
    pack = slog_packed(cfg)

    def tagged(words, typ, base):
        sent = words[:, 0] == _MAX
        for l in range(1, L):
            sent = sent & (words[:, l] == _MAX)
        cols = tuple(words[:, l] for l in range(L))
        if pack:
            tag = jnp.where(sent, jnp.uint32(0xFF), jnp.uint32(typ) | base)
            return _shl8_or(cols, tag)
        tags = jnp.where(sent, _MAX, jnp.uint32(typ) | base)
        return cols + (tags,)

    @jax.jit
    def run(a_cols, seq, w_i, w_q, w_r):
        base = seq.astype(jnp.uint32) << 2
        # constant per-stream tags keep each sorted stream (word, tag)-
        # sorted; sentinel rows stay all-ones and at the end
        b = merge_sorted_pair(tagged(w_i, 1, base),
                              tagged(w_q, 2, base))
        b = merge_sorted_pair(b, tagged(w_r, 3, base))
        merged = merge_sorted_pair(a_cols, b) if a_cap else b
        total = a_cap + nk_i + nk_q + nk_r
        if total > out_cap:
            merged = tuple(c[:out_cap] for c in merged)
        elif total < out_cap:
            pad = jnp.full((out_cap - total,), _MAX, jnp.uint32)
            merged = tuple(jnp.concatenate([c, pad]) for c in merged)
        positive, live = slog_counts(
            merged, base | jnp.uint32(2), pack
        )
        return merged, positive, live

    return run


@lru_cache(maxsize=None)
def _kmer_word_fn(cfg: CBLConfig, canonical: bool):
    """[N, L] k-mer limbs -> [N, L] packed words (point-op path,
    `src/cbl.rs:199-206`)."""

    def run(kmers):
        if canonical:
            kmers, _ = kmod.canonicalize(kmers, cfg)
        best, pos = necklace.necklace_pos(kmers, cfg)
        return necklace.pack_word(best, pos, cfg)

    return jax.jit(run)


class PackedStream:
    """A record stream staged on device: per-slab (nk_pad, stream, starts,
    ends, n_kmers) with all arrays already device-resident.  Build once via
    `CBL.pack_stream`, then pass to insert/remove/query_codes_stream —
    repeated passes over the same reads (the reference CLI's build+query
    pattern) pay the host->device transfer only once."""

    def __init__(self, cfg: CBLConfig, canonical: bool, slabs: list):
        self.cfg = cfg
        self.canonical = canonical
        self.slabs = slabs
        # per-slab memo of the necklace transform: slab idx -> (words
        # device array, n_valid device scalar).  The transform is a pure
        # function of the (immutable) staged stream, so an insert pass
        # populates it and later query/remove passes over the SAME
        # PackedStream reuse it instead of re-running the pipeline —
        # the reference analogously amortises its necklace queues across
        # a chunk (`/root/reference/src/cbl.rs:239-289`); disable with
        # CBL_TPU_NO_WORDS_CACHE=1 for pipeline-per-pass timings.
        import os

        self._words: dict = {}
        self._cache_on = not os.environ.get("CBL_TPU_NO_WORDS_CACHE")

    @property
    def n_kmers(self) -> int:
        return sum(s[4] for s in self.slabs)


class CBL:
    """A fully dynamic, exact set of k-mers (CBL method).

    Parameters mirror the reference's const generics: `k` (odd, <= 59) and
    `prefix_bits` (`/root/reference/src/cbl.rs:34-46`).
    """

    def __init__(
        self,
        k: int = 25,
        prefix_bits: int = 24,
        canonical: bool = False,
        chunk_size: int = DEFAULT_CHUNK,
        pending_cap: int | None = None,
    ):
        self.cfg = get_config(k=k, prefix_bits=prefix_bits)
        self.canonical = canonical
        self.chunk = chunk_size
        kwargs = {} if pending_cap is None else {"pending_cap": pending_cap}
        self.wordset = DeviceWordSet(self.cfg, **kwargs)

    # --- constructors (`src/cbl.rs:71-79`) ---

    @classmethod
    def new(cls, k: int = 25, prefix_bits: int = 24, **kw) -> "CBL":
        return cls(k=k, prefix_bits=prefix_bits, canonical=False, **kw)

    @classmethod
    def new_canonical(cls, k: int = 25, prefix_bits: int = 24, **kw) -> "CBL":
        return cls(k=k, prefix_bits=prefix_bits, canonical=True, **kw)

    def _like(self) -> "CBL":
        return CBL(
            k=self.cfg.k,
            prefix_bits=self.cfg.prefix_bits,
            canonical=self.canonical,
            chunk_size=self.chunk,
        )

    # --- basic queries (`src/cbl.rs:164-177`) ---

    def is_canonical(self) -> bool:
        return self.canonical

    def count(self) -> int:
        return self.wordset.count()

    def count_device(self):
        """`count` as an unsynced device scalar (see
        `DeviceWordSet.count_device`)."""
        return self.wordset.count_device()

    def is_empty(self) -> bool:
        return self.wordset.is_empty()

    def __len__(self) -> int:
        return self.count()

    # --- sequence pipeline ---

    def _codes_of(self, seq) -> np.ndarray:
        if isinstance(seq, np.ndarray) and seq.dtype == np.uint8:
            return seq
        return kmod.encode_seq(seq)

    def _effective_chunk(self, total_kmers: int) -> int:
        """Scale the chunk to the workload: small inputs compile/run small
        programs, large streams use the full configured chunk (power-of-two
        tiers keep the jit cache bounded)."""
        if total_kmers <= 0:
            return min(self.chunk, 4096)
        tier = 1 << max(total_kmers - 1, 1).bit_length()
        eff = max(min(self.chunk, tier), 4096)
        # chunk windows must fall on 16-base packed-word boundaries
        return (eff + 15) // 16 * 16

    def _stream_chunks(self, codes: np.ndarray, valid: np.ndarray, chunk: int):
        """Yield (stream [S/16] u32, validbits [chunk/8] u8, valid [chunk],
        n_kmers) windows; both device inputs are bit-packed host-side.

        The whole code/valid stream is packed ONCE (vectorized) and chunk
        windows are word-aligned slices of it — chunk sizes are powers of two
        >= 4096, so every chunk boundary falls on a 16-base word boundary and
        an 8-k-mer byte boundary.  Per-chunk host cost drops from
        alloc+copy+pack to two slice views."""
        k = self.cfg.k
        S = _stream_len(chunk, k)
        total = len(valid)
        if total <= 0:
            return
        n_chunks = (total + chunk - 1) // chunk
        cbuf = np.zeros((n_chunks - 1) * chunk + S, dtype=np.uint8)
        cbuf[: len(codes)] = codes[: len(cbuf)]
        packed = kmod.np_pack_stream(cbuf)
        vfull = np.zeros(n_chunks * chunk, dtype=bool)
        vfull[:total] = valid
        vbits_all = np.packbits(vfull)
        nw = S // 16
        for i in range(n_chunks):
            start = i * chunk
            n = min(chunk, total - start)
            yield (
                packed[start // 16 : start // 16 + nw],
                vbits_all[start // 8 : start // 8 + chunk // 8],
                vfull[start : start + chunk],
                n,
            )

    def _stream_valid(self, codes: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        """Valid-start mask for a concatenated record stream: a k-mer is
        valid iff it lies entirely inside one record (the reference forms
        k-mers per record; k-mers never span records)."""
        k = self.cfg.k
        nk = max(len(codes) - k + 1, 0)
        if nk == 0:
            return np.zeros(0, dtype=bool)
        # vectorized interval blanking (inputs can have millions of records):
        # each interior boundary b blanks starts [b-k+1, b); accumulate the
        # intervals as +1/-1 deltas and mark covered positions by prefix sum
        b = np.asarray(offsets[1:-1], dtype=np.int64)
        starts = np.clip(b - k + 1, 0, nk)
        ends = np.clip(b, 0, nk)
        # short trailing record: no k-mer may start inside it
        if len(offsets) >= 2 and offsets[-1] - offsets[-2] < k:
            starts = np.append(starts, max(offsets[-2] - k + 1, 0))
            ends = np.append(ends, nk)
        delta = np.zeros(nk + 1, dtype=np.int64)
        np.add.at(delta, starts, 1)
        np.add.at(delta, ends, -1)
        return np.cumsum(delta[:nk]) == 0

    def _stream_words(self, codes: np.ndarray, valid: np.ndarray):
        chunk = self._effective_chunk(len(valid))
        fn = _pipeline_fn(self.cfg, self.canonical, chunk)
        for stream, vbits, vbuf, n in self._stream_chunks(codes, valid, chunk):
            yield fn(stream, vbits), vbuf, n

    def _seqs_words(self, seqs):
        """Concatenate sequences into one base stream; yield per-chunk word
        arrays.  K-mers never span sequence boundaries."""
        k = self.cfg.k
        parts = []
        for s in seqs:
            c = self._codes_of(s)
            if len(c) >= k:
                parts.append(c)
        if not parts:
            return
        codes = np.concatenate(parts)
        offsets = np.cumsum([0] + [len(c) for c in parts], dtype=np.int64)
        yield from self._stream_words(codes, self._stream_valid(codes, offsets))

    # --- streaming fast path (feeds straight from io.parse_fastx) ---

    def _blank_intervals(self, offsets, nk: int):
        """[start, end) intervals of k-mer start positions that must be
        blanked: record-boundary halos (k-mers never span records) and short
        trailing records.  Mirrors `_stream_valid` (host mask) as interval
        endpoints suitable for on-device reconstruction."""
        k = self.cfg.k
        b = np.asarray(offsets[1:-1], dtype=np.int64)
        starts = np.clip(b - k + 1, 0, nk)
        ends = np.clip(b, 0, nk)
        if len(offsets) >= 2 and offsets[-1] - offsets[-2] < k:
            starts = np.append(starts, max(int(offsets[-2]) - k + 1, 0))
            ends = np.append(ends, nk)
        return starts, ends

    def _fused_slabs(self, codes: np.ndarray, offsets: np.ndarray,
                     slab: int | None = None, uniform: bool = False):
        """Yield (nk_pad, stream, starts, ends, n_kmers_here) per fused slab.

        The whole code stream is 2-bit packed ONCE (native SIMD); slab
        windows are 16-base-aligned views with the K-1 halo included
        (`/root/reference/src/cbl.rs:239-243` chunk-overlap semantics).
        starts/ends are int32 blank intervals local to the slab, padded to a
        power-of-two length with the dropped index nk_pad + 1.

        slab: override the slab size (power of two >= 4096); uniform pads
        the final slab to the full size too (sharded callers stack D slab
        inputs into one array)."""
        from .wordset import _next_pow2

        k = self.cfg.k
        nk = max(len(codes) - k + 1, 0)
        if nk == 0:
            return
        g_starts, g_ends = self._blank_intervals(offsets, nk)
        slab = _FUSED_SLAB if slab is None else slab
        n_slabs = (nk + slab - 1) // slab
        last_nk = nk - (n_slabs - 1) * slab
        last_pad = slab if uniform else max(_next_pow2(last_nk), 4096)
        total_bases = (n_slabs - 1) * slab + _stream_len(last_pad, k)
        cbuf = np.zeros(total_bases, dtype=np.uint8)
        cbuf[: min(len(codes), total_bases)] = codes[:total_bases]
        packed = kmod.np_pack_stream(cbuf)
        for i in range(n_slabs):
            s0 = i * slab
            nk_pad = slab if i < n_slabs - 1 else last_pad
            nw = _stream_len(nk_pad, k) // 16
            stream = packed[s0 // 16 : s0 // 16 + nw]
            n_here = min(slab, nk - s0)
            ss = np.clip(g_starts - s0, 0, nk_pad)
            ee = np.clip(g_ends - s0, 0, nk_pad)
            if n_here < nk_pad:  # blank the padded tail
                ss = np.append(ss, n_here)
                ee = np.append(ee, nk_pad)
            cap = max(_next_pow2(max(len(ss), 1)), 16)
            drop = nk_pad + 1
            s_arr = np.full(cap, drop, dtype=np.int32)
            s_arr[: len(ss)] = ss
            e_arr = np.full(cap, drop, dtype=np.int32)
            e_arr[: len(ee)] = ee
            yield nk_pad, stream, s_arr, e_arr, n_here

    def pack_stream(self, codes: np.ndarray, offsets: np.ndarray) -> "PackedStream":
        """Stage a record stream on device once (async transfers) so
        insert/remove/query can all run against it without re-transferring
        over the host link — the device-memory analog of the reference
        holding the parsed reads in RAM across its build+query passes."""
        slabs = [
            (
                nk_pad,
                jax.device_put(stream),
                jax.device_put(s_arr),
                jax.device_put(e_arr),
                n_here,
            )
            for nk_pad, stream, s_arr, e_arr, n_here in self._fused_slabs(
                codes, offsets
            )
        ]
        return PackedStream(self.cfg, self.canonical, slabs)

    def _resolve_stream(self, codes, offsets) -> "PackedStream":
        if isinstance(codes, PackedStream):
            if (codes.cfg, codes.canonical) != (self.cfg, self.canonical):
                raise ValueError("PackedStream built for a different config")
            return codes
        return self.pack_stream(codes, offsets)

    def insert_codes_stream(self, codes, offsets: np.ndarray | None = None) -> None:
        """Insert every k-mer of a concatenated code stream with record
        `offsets` ([n_records+1]), or of a pre-staged `PackedStream`.
        CLI/bench hot path: ONE fused device program per <=2^25-k-mer slab
        (extract+necklace+pack+blank+sort), adopted directly when the index
        is empty, else folded with one sort-merge per slab."""
        ws = self.wordset
        ws.flush()
        ps = self._resolve_stream(codes, offsets)
        for i, (nk_pad, stream, s_arr, e_arr, n_here) in enumerate(ps.slabs):
            if ws._n_upper == 0:
                data, n_dev, n_valid = _fused_build_fn(
                    self.cfg, self.canonical, nk_pad
                )(stream, s_arr, e_arr)
                if ps._cache_on:
                    # cache a COPY: the wordset owns `data` and its merge
                    # kernels donate it; sorted rows are equally valid as
                    # future query words (joins are order-free), and the
                    # True flag lets a later self-query skip its sort
                    # entirely (merge-join of two sorted runs)
                    ps._words[i] = (data + jnp.uint32(0), n_valid, True)
                ws.adopt_built(data, n_dev, n_here)
            else:
                words, n_valid = _fused_words_sorted_fn(
                    self.cfg, self.canonical, nk_pad
                )(stream, s_arr, e_arr)
                if ps._cache_on:
                    ps._words[i] = (words, n_valid, True)
                if words.shape[0] + ws.n_pending <= ws.pending_cap:
                    # append to the pending log: interleaved insert/remove
                    # rounds then fold ONCE at the next query instead of
                    # paying a separate merge sort per call
                    ws.insert_words(words)
                else:
                    ws._merge_into(
                        words, n_new_upper=n_here, batch_sorted=True
                    )

    def remove_codes_stream(self, codes, offsets: np.ndarray | None = None) -> None:
        ps = self._resolve_stream(codes, offsets)
        batches = []
        for i, (nk_pad, stream, s_arr, e_arr, _) in enumerate(ps.slabs):
            cached = ps._words.get(i)
            if cached is None:
                cached = _fused_words_fn(self.cfg, self.canonical, nk_pad)(
                    stream, s_arr, e_arr
                ) + (False,)
                if ps._cache_on:
                    ps._words[i] = cached
            batches.append(cached[0])
        if batches:
            self.wordset.remove_words(
                batches[0] if len(batches) == 1 else jnp.concatenate(batches)
            )

    def query_codes_stream(self, codes, offsets: np.ndarray | None = None,
                           lazy: bool = False):
        """(total_kmers, positive_kmers) over a record stream (or a
        pre-staged `PackedStream`) — the CLI `query` counters
        (`/root/reference/examples/cbl.rs:212-228`).

        One fused device program per slab; both counters accumulate on
        device and sync ONCE at the end of the stream.  With lazy=True the
        device scalars are returned unsynced (interleaved benchmarks sum
        them and sync once per workload)."""
        ws = self.wordset
        ps = self._resolve_stream(codes, offsets)
        total_dev = positive_dev = None
        if ws.n_pending > 0 or ws._slog is not None:
            # unflushed pending LOG or active sorted-log: join against the
            # live representation per slab via count_hits_device (never
            # forces a fold — the interleaved-workload contract)
            for i, (nk_pad, stream, s_arr, e_arr, _) in enumerate(ps.slabs):
                cached = ps._words.get(i)
                if cached is None:
                    cached = _fused_words_fn(
                        self.cfg, self.canonical, nk_pad
                    )(stream, s_arr, e_arr) + (False,)
                    if ps._cache_on:
                        ps._words[i] = cached
                t, p = cached[1], ws.count_hits_device(cached[0])
                total_dev = t if total_dev is None else total_dev + t
                positive_dev = p if positive_dev is None else positive_dev + p
            if total_dev is None:
                return (0, 0) if not lazy else (jnp.int32(0), jnp.int32(0))
            if lazy:
                return total_dev, positive_dev
            t, p = jax.device_get((total_dev, positive_dev))
            return int(t), int(p)
        data = ws._live()
        packed_ok = self.cfg.n_bits <= 32 * ws.L - 2
        from .wordset import (
            _count_hits_kernel,
            _count_hits_kernel_packed,
            _count_hits_merge_kernel,
            _count_hits_merge_sorted_kernel,
        )

        if not packed_ok:
            join = _count_hits_kernel
        elif ws._holes:
            join = _count_hits_kernel_packed
        else:
            join = _count_hits_merge_kernel
        for i, (nk_pad, stream, s_arr, e_arr, _) in enumerate(ps.slabs):
            cached = ps._words.get(i)
            if cached is not None:
                if cached[2] and join is _count_hits_merge_kernel:
                    # memo holds SORTED rows (build-slab cache): both sides
                    # sorted -> one merge pass, no query sort at all
                    t, p = cached[1], _count_hits_merge_sorted_kernel(
                        data, cached[0]
                    )
                else:
                    t, p = cached[1], join(data, cached[0])
            else:
                t, p = _fused_query_fn(
                    self.cfg, self.canonical, nk_pad, ws._holes
                )(stream, s_arr, e_arr, data)
            total_dev = t if total_dev is None else total_dev + t
            positive_dev = p if positive_dev is None else positive_dev + p
        if total_dev is None:
            return (0, 0) if not lazy else (jnp.int32(0), jnp.int32(0))
        if lazy:
            return total_dev, positive_dev
        t, p = jax.device_get((total_dev, positive_dev))
        return int(t), int(p)

    def dynamic_round(self, ins, qry, rm, lazy: bool = False):
        """One interleaved round — insert every k-mer of `ins`, count-query
        `qry` (sees the inserts, not yet the removes), remove every k-mer
        of `rm` — fused into ONE device program for single-slab streams
        (the sorted-log representation, `_fused_round_slog_fn`); otherwise
        the separate calls.  Args are PackedStreams or (codes, offsets)
        tuples.  Returns (total, positive) ints, or unsynced device
        scalars with lazy=True."""
        ps_i = self._resolve_round_stream(ins)
        ps_q = self._resolve_round_stream(qry)
        ps_r = self._resolve_round_stream(rm)
        ws = self.wordset
        fusable = (
            len(ps_i.slabs) == 1 and len(ps_q.slabs) == 1
            and len(ps_r.slabs) == 1
        )
        if not fusable:
            self.insert_codes_stream(ps_i)
            t, p = self.query_codes_stream(ps_q, lazy=lazy)
            self.remove_codes_stream(ps_r)
            return t, p
        w_i, _ = self._sorted_slab_words(ps_i)
        w_q, total = self._sorted_slab_words(ps_q)
        w_r, _ = self._sorted_slab_words(ps_r)
        nk_i, nk_q, nk_r = (w.shape[0] for w in (w_i, w_q, w_r))
        if ws.n_pending > 0:
            ws.flush()
        if ws._slog_pack and ws._slog_seq >= _SLOG_SEQ_MAX:
            ws._fold_slog()  # the packed 8-bit tag caps round_seq at 62
        ws.maybe_autofold_slog()
        n_slog_cols = ws.L if ws._slog_pack else ws.L + 1
        if ws._slog is None:
            if ws._holes:
                ws._compact()
            if ws._n_upper == 0:
                a_cols = tuple(
                    jnp.zeros((0,), jnp.uint32) for _ in range(n_slog_cols)
                )
                a_real = 0
            else:
                from .wordset import _data_to_slog_cols

                live = ws._live()
                a_cols = _data_to_slog_cols(live, ws._slog_pack)
                a_real = min(ws._n_upper, live.shape[0])
        else:
            a_cols = ws._slog
            a_real = ws._slog_real
        from .wordset import _quantize_cap

        a_cap = a_cols[0].shape[0]
        new_real = a_real + nk_i + nk_q + nk_r
        out_cap = a_cap if new_real <= a_cap else _quantize_cap(new_real)
        seq = ws._slog_seq + 1
        fn = _fused_round_slog_fn(
            self.cfg, nk_i, nk_q, nk_r, a_cap, out_cap
        )
        merged, positive, live = fn(a_cols, np.uint32(seq), w_i, w_q, w_r)
        # commit state only after the round program was built and enqueued
        # (a compile/launch failure must not advance the log sequence)
        ws._slog = merged
        ws._slog_seq = seq
        ws._slog_real = new_real
        ws._slog_count_dev = live  # free by-product of the round's scan
        ws._n_upper = min(ws._n_upper + nk_i, out_cap)
        ws._invalidate_index()
        if lazy:
            return total, positive
        t, p = jax.device_get((total, positive))
        return int(t), int(p)

    def _sorted_slab_words(self, ps: "PackedStream"):
        """(sorted words [nk_pad, L], n_valid device scalar) of a
        single-slab stream, through the PackedStream memo: a stream whose
        words were already computed (its own insert pass, or an earlier
        round) never re-runs the pipeline, and one that was already
        SORTED never re-sorts."""
        from .wordset import sort_rows

        nk_pad, stream, s_arr, e_arr, _ = ps.slabs[0]
        cached = ps._words.get(0)
        if cached is None:
            words, n_valid = _fused_words_sorted_fn(
                self.cfg, self.canonical, nk_pad
            )(stream, s_arr, e_arr)
            cached = (words, n_valid, True)
        elif not cached[2]:
            cached = (sort_rows(cached[0]), cached[1], True)
        if ps._cache_on:
            ps._words[0] = cached
        return cached[0], cached[1]

    def _resolve_round_stream(self, x) -> "PackedStream":
        if isinstance(x, PackedStream):
            return self._resolve_stream(x, None)
        if isinstance(x, tuple):
            return self._resolve_stream(*x)
        raise TypeError(
            "dynamic_round takes PackedStreams or (codes, offsets) tuples"
        )

    def _check_len(self, seq) -> None:
        # `src/cbl.rs:293-298`: assert seq.len() >= K
        if len(seq) < self.cfg.k:
            raise ValueError(
                f"Sequence size ({len(seq)}) is smaller than K ({self.cfg.k})"
            )

    # --- sequence ops (`src/cbl.rs:293-354`) ---

    def insert_seq(self, seq) -> None:
        self._check_len(seq)
        self.insert_seqs([seq])

    def insert_seqs(self, seqs) -> None:
        for words, _, _ in self._seqs_words(seqs):
            self.wordset.insert_words(words)

    def remove_seq(self, seq) -> None:
        self._check_len(seq)
        self.remove_seqs([seq])

    def remove_seqs(self, seqs) -> None:
        batches = [w for w, _, _ in self._seqs_words(seqs)]
        if batches:
            self.wordset.remove_words(jnp.concatenate(batches, axis=0))

    def contains_seq(self, seq) -> np.ndarray:
        """Per-k-mer membership, in sequence order (see module docstring)."""
        self._check_len(seq)
        return self.contains_seqs([seq])[0]

    def contains_seqs(self, seqs) -> list[np.ndarray]:
        """Ordered membership masks for a whole sequence batch in O(slabs)
        device programs + ONE device transfer (not one dispatch + flush per
        sequence)."""
        for s in seqs:
            self._check_len(s)
        codes_list = [self._codes_of(s) for s in seqs]
        offsets = np.cumsum([0] + [len(c) for c in codes_list],
                            dtype=np.int64)
        codes = (
            np.concatenate(codes_list)
            if codes_list
            else np.zeros(0, dtype=np.uint8)
        )
        return self.contains_codes_stream(codes, offsets)

    def contains_codes_stream(self, codes: np.ndarray,
                              offsets: np.ndarray) -> list[np.ndarray]:
        """Per-record ordered membership masks over a concatenated code
        stream (the bulk `contains_seq`): record r gets a bool array of its
        max(len_r - K + 1, 0) k-mers in sequence order."""
        k = self.cfg.k
        flat = self._contains_flat(codes, offsets)
        out = []
        for r in range(len(offsets) - 1):
            lo = int(offsets[r])
            hi = max(int(offsets[r + 1]) - k + 1, lo)
            out.append(flat[lo:hi])
        return out

    def _contains_flat(self, codes: np.ndarray,
                       offsets: np.ndarray) -> np.ndarray:
        """[nk] bool mask over every k-mer start of the code stream
        (record-spanning starts are False).  Large streams use the fused
        slab sort-join (one program per <=2^25-k-mer slab); small ones the
        radix-window/binary-search word path (a sort-join would pay a full
        index sort for a handful of queries)."""
        from .wordset import _SORTJOIN_MIN_QUERIES

        nk = max(len(codes) - self.cfg.k + 1, 0)
        self.wordset.flush()
        if nk == 0:
            return np.zeros(0, dtype=bool)
        if nk >= _SORTJOIN_MIN_QUERIES:
            data = self.wordset._live()
            masks, ns = [], []
            for nk_pad, stream, s_arr, e_arr, n_here in self._fused_slabs(
                codes, offsets
            ):
                masks.append(
                    _fused_contains_fn(self.cfg, self.canonical, nk_pad)(
                        stream, s_arr, e_arr, data
                    )
                )
                ns.append(n_here)
            host = jax.device_get(masks)  # one transfer for the stream
            return np.concatenate([m[:n] for m, n in zip(host, ns)])
        masks, ns = [], []
        for words, _, n in self._stream_words(
            codes, self._stream_valid(codes, offsets)
        ):
            masks.append(self.wordset.contains_words(words))
            ns.append(n)
        if not masks:
            return np.zeros(0, dtype=bool)
        host = jax.device_get(masks)
        return np.concatenate([m[:n] for m, n in zip(host, ns)])

    def contains_all(self, seq) -> bool:
        """True iff every k-mer of `seq` is present
        (`/root/reference/src/cbl.rs:291-307`)."""
        self._check_len(seq)
        codes = self._codes_of(seq)
        if len(codes) < self.cfg.k:
            return True
        offsets = np.array([0, len(codes)], dtype=np.int64)
        total, positive = self.query_codes_stream(codes, offsets)
        return positive == total

    def __contains__(self, kmer_int: int) -> bool:
        return self.contains(kmer_int)

    # --- point ops (`src/cbl.rs:219-235`); k-mers given as packed ints ---

    def _word_rows_of_kmers(self, kmers_int) -> jax.Array:
        rows = limbs.from_py_ints([int(v) for v in kmers_int], self.cfg.kmer_limbs)
        return _kmer_word_fn(self.cfg, self.canonical)(jnp.asarray(rows))

    def contains(self, kmer_int: int) -> bool:
        return bool(np.asarray(self.contains_kmers([kmer_int]))[0])

    def insert(self, kmer_int: int) -> bool:
        """Returns True if the k-mer was absent (reference contract)."""
        words = self._word_rows_of_kmers([kmer_int])
        absent = not bool(np.asarray(self.wordset.contains_words(words))[0])
        self.wordset.insert_words(words)
        return absent

    def remove(self, kmer_int: int) -> bool:
        """Returns True if the k-mer was present (reference contract)."""
        words = self._word_rows_of_kmers([kmer_int])
        present = bool(np.asarray(self.wordset.contains_words(words))[0])
        self.wordset.remove_words(words)
        return present

    def contains_kmers(self, kmers_int) -> np.ndarray:
        words = self._word_rows_of_kmers(kmers_int)
        return np.asarray(self.wordset.contains_words(words))

    def insert_kmers(self, kmers_int) -> None:
        self.wordset.insert_words(self._word_rows_of_kmers(kmers_int))

    def remove_kmers(self, kmers_int) -> None:
        self.wordset.remove_words(self._word_rows_of_kmers(kmers_int))

    # --- iteration (`src/cbl.rs:358-360`) ---

    def kmers_limbs(self) -> np.ndarray:
        """[n, L] k-mer limb rows, ascending packed-word order.

        Decode runs HOST-side on the exported words (numpy twins of the
        device decode): the list path is transfer-bound, so the only
        device<->host traffic is the single words_array() export."""
        words = self.wordset.words_array()
        if words.shape[0] == 0:
            return words
        return necklace.np_word_to_kmer(words, self.cfg)

    def __iter__(self):
        for row in self.kmers_limbs():
            yield limbs.to_py_ints(row[None, :])[0]

    def iter_nucs(self, chunk_rows: int = 1 << 20):
        """Yield k-mers as ASCII bytes (CLI `list`).

        Streams the index in bounded chunks — device->host transfer AND
        host decode both per-chunk, so listing a huge index never
        materialises it (reference lazy iteration,
        `/root/reference/src/wordset/mod.rs:298-362`)."""
        lut = kmod.BASE_LOOKUP
        for words in self.wordset.iter_words_chunks(chunk_rows):
            km = necklace.np_word_to_kmer(words, self.cfg)
            ascii_rows = lut[kmod.np_unpack_bases(km, self.cfg)]
            for row in ascii_rows:
                yield row.tobytes()

    # --- set algebra (`src/cbl.rs:411-569`) ---

    def _check_mode(self, other: "CBL") -> None:
        if self.canonical != other.canonical:
            raise ValueError("One of the index is canonical while the other isn't")
        if self.cfg != other.cfg:
            raise ValueError("Mismatched CBL configurations")

    def __or__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        out = self._like()
        out.wordset = self.wordset.union(other.wordset)
        return out

    def __ior__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        self.wordset = self.wordset.union(other.wordset)
        return self

    def __and__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        out = self._like()
        out.wordset = self.wordset.intersection(other.wordset)
        return out

    def __iand__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        self.wordset = self.wordset.intersection(other.wordset)
        return self

    def __sub__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        out = self._like()
        out.wordset = self.wordset.difference(other.wordset)
        return out

    def __isub__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        self.wordset = self.wordset.difference(other.wordset)
        return self

    def __xor__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        out = self._like()
        out.wordset = self.wordset.symmetric_difference(other.wordset)
        return out

    def __ixor__(self, other: "CBL") -> "CBL":
        self._check_mode(other)
        self.wordset = self.wordset.symmetric_difference(other.wordset)
        return self

    @classmethod
    def merge(cls, cbls: list["CBL"]) -> "CBL":
        """k-way union (`src/cbl.rs:106-114`)."""
        assert cbls
        for c in cbls[1:]:
            cbls[0]._check_mode(c)
        out = cbls[0]._like()
        out.wordset = DeviceWordSet.merge_many([c.wordset for c in cbls])
        return out

    @classmethod
    def intersect(cls, cbls: list["CBL"]) -> "CBL":
        """k-way intersection (`src/cbl.rs:116-124`)."""
        assert cbls
        for c in cbls[1:]:
            cbls[0]._check_mode(c)
        out = cbls[0]._like()
        out.wordset = DeviceWordSet.intersect_many([c.wordset for c in cbls])
        return out

    # --- persistence (`src/cbl.rs:127-160`) ---

    def save_to_file(self, path) -> None:
        from . import serialize

        serialize.save(self, path)

    @classmethod
    def load_from_file(cls, path) -> "CBL":
        from . import serialize

        return serialize.load(path)

    # --- repartition stats (`src/cbl.rs:364-396`) ---

    def prefix_load(self) -> float:
        from . import stats

        return stats.prefix_load(self)

    def buckets_sizes(self):
        from . import stats

        return stats.buckets_sizes(self)

    def buckets_size_count(self):
        from . import stats

        return stats.buckets_size_count(self)

    def buckets_load_repartition(self):
        from . import stats

        return stats.buckets_load_repartition(self)

    def buckets_nodes(self):
        from . import stats

        return stats.buckets_nodes(self)

    def buckets_node_count(self):
        from . import stats

        return stats.buckets_node_count(self)
