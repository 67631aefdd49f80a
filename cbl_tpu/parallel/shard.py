"""Multi-device prefix-space sharding.

The reference is single-threaded CPU (SURVEY.md §2.9): it has *no* parallel
components.  The natural distribution seam it exposes is the prefix/suffix
radix split (`/root/reference/src/wordset/mod.rs:63-71`): the word space is
an ordered radix partition, so sharding by the **top SHARD_BITS bits of the
packed word** gives every device an independent slice of the index whose
concatenation reproduces the single-device iteration order exactly.

Design:
- mesh: 1-D `('d',)` over all devices; index state [D, C, L] sharded on d.
- routing (EP-style all-to-all): each device computes words from its local
  read batch, bucket-sorts them by owner shard, and exchanges buckets with
  `jax.lax.all_to_all` over the device interconnect.
- update: each shard folds received words into its sorted slice with the
  same merge program as the single-chip path.
- counts / reductions: local counts + `psum`.
- set algebra: partitions are aligned, so union/intersection/… are purely
  local shard-wise merges — embarrassingly parallel.

Sentinel routing trick: invalid word rows are all-ones, so their "owner" is
shard D-1, where the merge compaction drops them — no separate masking.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import limbs
from ..config import CBLConfig
from ..ops.merge import merge_with_unsorted, sort_cols
from ..wordset import (
    MIN_CAP,
    _U32_MAX,
    _compact,
    _next_pow2,
    _sortjoin_hits,
    _valid_mask,
    sort_rows,
)

AXIS = "d"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (AXIS,))


# Routing note: plain top-bits sharding is catastrophically skewed for
# necklaces (a minimal rotation statistically starts with ~log2(2K) zero
# bits, so top bits are almost always 0 — observed 98% of words on shard
# 0).  The range partition by D-1 data-quantile boundaries keeps
# shard-major order equal to global sorted order while balancing load
# (SURVEY.md §7 "load-aware prefix partitioning"); owner runs of SORTED
# rows are contiguous, so every path routes through `_route_sorted`
# below — the round-1 [B, D] one-hot + cumsum + scatter bucketing
# (O(B*D) work, quadratic at pod device counts) is gone.


@lru_cache(maxsize=None)
def _insert_step_fn(cfg: CBLConfig, mesh: Mesh, C: int, B: int):
    """jitted ([D, C, L] state, [D, B, L] words, [D-1, L] boundaries) ->
    new state + per-shard counts."""
    D = mesh.devices.size
    L = cfg.word_limbs

    def local_step(data, words, boundaries):
        # data: [1, C, L] local slice; words: [1, B, L] local batch
        data = data[0]
        words = words[0]
        send, _ = _route_sorted(sort_rows(words), boundaries, D, B)
        recv = jax.lax.all_to_all(send, AXIS, split_axis=0, concat_axis=0, tiled=True)
        cat = jnp.concatenate([data, recv.reshape(D * B, L)], axis=0)
        s = sort_rows(cat)
        prev_eq = jnp.concatenate(
            [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
        )
        keep = _valid_mask(s) & ~prev_eq
        # compaction-by-sorting (no scatters; see wordset._setop_sort_kernel)
        s = jnp.where(keep[:, None], s, jnp.uint32(0xFFFFFFFF))
        s = sort_rows(s)
        return s[None, :C], jnp.sum(keep.astype(jnp.int32))[None]

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    return jax.jit(step, donate_argnums=(0,))


@lru_cache(maxsize=None)
def _remove_step_fn(cfg: CBLConfig, mesh: Mesh, C: int, B: int):
    """jitted ([D, C, L] state, [D, B, L] words, boundaries) -> new state +
    per-shard counts.  Same routing as the insert step; the local fold is the
    tagged-sort set difference (wordset._setop_sort_kernel 'remove'
    semantics): batch rows sort FIRST among equal words, so a data row whose
    predecessor equals it is scheduled for removal."""
    D = mesh.devices.size
    L = cfg.word_limbs

    def local_step(data, words, boundaries):
        data = data[0]
        words = words[0]
        send, _ = _route_sorted(sort_rows(words), boundaries, D, B)
        recv = jax.lax.all_to_all(send, AXIS, split_axis=0, concat_axis=0, tiled=True)
        batch = recv.reshape(D * B, L)
        rows = jnp.concatenate([data, batch], axis=0)
        tag = jnp.concatenate(
            [
                jnp.ones((data.shape[0],), jnp.uint32),
                jnp.zeros((batch.shape[0],), jnp.uint32),
            ]
        )
        ops = tuple(rows[:, l] for l in range(L)) + (tag,)
        sorted_ops = sort_cols(ops)
        s = jnp.stack(sorted_ops[:L], axis=-1)
        is_data = sorted_ops[L] == 1
        prev_eq = jnp.concatenate(
            [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
        )
        keep = _valid_mask(s) & is_data & ~prev_eq
        s = jnp.where(keep[:, None], s, jnp.uint32(0xFFFFFFFF))
        s = sort_rows(s)
        return s[None, :C], jnp.sum(keep.astype(jnp.int32))[None]

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    return jax.jit(step, donate_argnums=(0,))


@lru_cache(maxsize=None)
def _contains_step_fn(cfg: CBLConfig, mesh: Mesh, C: int, B: int):
    """jitted ([D, C, L] state, [D, B, L] queries, boundaries) -> [D, B] hit
    mask, with results routed back to the querying device in original order."""
    D = mesh.devices.size
    L = cfg.word_limbs
    from ..wordset import _contains_kernel

    def local_step(data, words, boundaries):
        data = data[0]
        words = words[0]
        if D == 1:
            hits = _contains_kernel(data, words) & _valid_mask(words)
            return hits[None]
        # sorted routing with the original position as payload: no [B, D]
        # one-hot, no scatter; the position column both routes results
        # back into query order (one small key sort) and kills pad/
        # sentinel artifacts (their position is the dtype max)
        pos = jnp.arange(B, dtype=jnp.uint32)
        sc = sort_cols(tuple(words[:, l] for l in range(L)) + (pos,))
        s = jnp.stack(sc[:L], axis=-1)
        send, (ppos,), _ = _route_sorted(
            s, boundaries, D, B, payload=(sc[L],), include_sentinels=True
        )
        recv = jax.lax.all_to_all(
            send, AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        rrows = recv.reshape(D * B, L)
        hits = _contains_kernel(data, rrows) & _valid_mask(rrows)
        back = jax.lax.all_to_all(
            hits.reshape(D, B), AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        flat_pos = ppos.reshape(D * B)
        flat_hit = jnp.where(
            flat_pos == _U32_MAX, jnp.uint32(0),
            back.reshape(D * B).astype(jnp.uint32),
        )
        ordered = sort_cols((flat_pos, flat_hit))[1][:B]
        return ordered.astype(bool)[None]

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P()),
        out_specs=P(AXIS),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    return jax.jit(step)


@lru_cache(maxsize=None)
def _count_hits_step_fn(cfg: CBLConfig, mesh: Mesh, C: int, B: int):
    """Distributed membership counting: route queries to owner shards, count
    locally with the sort-join kernel, psum the counts."""
    D = mesh.devices.size
    L = cfg.word_limbs
    from ..wordset import _count_hits_kernel, _count_hits_kernel_packed

    count_kernel = (
        _count_hits_kernel_packed
        if cfg.n_bits <= 32 * L - 2
        else _count_hits_kernel
    )

    def local_step(data, words, boundaries):
        data = data[0]
        words = words[0]
        send, _ = _route_sorted(sort_rows(words), boundaries, D, B)
        recv = jax.lax.all_to_all(send, AXIS, split_axis=0, concat_axis=0, tiled=True)
        local = count_kernel(data, recv.reshape(D * B, L))
        return jax.lax.psum(local, AXIS)[None]

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P()),
        out_specs=P(AXIS),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    return jax.jit(step)


def _route_sorted(s, boundaries, D: int, bucket_cap: int, payload=(),
                  include_sentinels: bool = False):
    """Build the [D, bucket_cap, L] all-to-all send buffer from SORTED rows.

    The range partition follows word order, so sorting makes owner runs
    contiguous (sentinels last).  Bucket b then occupies rows
    [off[b], off[b+1]) and the padded send buffer is ONE row gather — no
    [B, D] one-hot matrix and no scatter (the one-hot cumsum is also
    O(B*D), quadratic at large device counts).  Returns (send, dropped)
    — or (send, payloads, dropped) when 1-D `payload` columns ride along
    (each gathered with the same permutation, pad slots = dtype max) —
    where dropped counts
    rows that exceeded bucket_cap (host raises; ~0 with quantile
    boundaries).  include_sentinels routes all-ones rows too (they sort
    after every boundary -> last bucket): ordered-query callers need
    every input row to come back."""
    B, L = s.shape
    if include_sentinels:
        valid = None
        n_valid = jnp.int32(B)
    else:
        valid = _valid_mask(s)
        n_valid = jnp.sum(valid.astype(jnp.int32))
    offs = [jnp.int32(0)]
    for b in range(D - 1):
        lt_b = limbs.lt(s, boundaries[b][None, :])
        if valid is not None:
            lt_b = valid & lt_b
        offs.append(jnp.sum(lt_b.astype(jnp.int32)))
    offs.append(n_valid)
    off = jnp.stack(offs)  # [D+1]
    cnt = off[1:] - off[:-1]
    j = jnp.arange(bucket_cap, dtype=jnp.int32)
    idx2 = off[:D, None] + j[None, :]  # [D, cap]
    src = jnp.clip(idx2, 0, B - 1)
    send = s[src]  # [D, cap, L]
    keep = j[None, :] < jnp.minimum(cnt, bucket_cap)[:, None]
    send = jnp.where(keep[..., None], send, _U32_MAX)
    dropped = jnp.sum(jnp.maximum(cnt - bucket_cap, 0))
    if not payload:
        return send, dropped
    outs = tuple(
        jnp.where(keep, p[src], jnp.array(np.iinfo(p.dtype).max, p.dtype))
        for p in payload
    )
    return send, outs, dropped


@lru_cache(maxsize=None)
def _bulk_insert_step_fn(cfg: CBLConfig, canonical: bool, mesh: Mesh,
                         nk_sub: int, C: int, C_new: int, bucket_cap: int,
                         empty: bool = False):
    """Fused DP front-end + EP routing + per-shard merge in ONE program:
    every device runs the whole k-mer pipeline on ITS slice of the base
    stream (`_device_words`), routes words to owner shards with a single
    tiled all-to-all, and folds its received bucket with one sort-merge.

    This is the bulk-slab insert the per-batch host loop lacked (one device
    program per D*nk_sub k-mers instead of one dispatch per D*2^14 words).
    Returns (state, per-shard counts, psum of rows dropped by bucket
    overflow — 0 unless the range partition is badly skewed; the host
    verifies and raises)."""
    from ..cbl import _device_words

    D = mesh.devices.size
    L = cfg.word_limbs

    def local_step(data, stream, starts, ends, boundaries):
        words, _ = _device_words(
            stream[0], starts[0], ends[0], nk_sub, cfg, canonical
        )
        if D == 1:
            # single shard: no routing; merge the slab directly
            batch = words
            dropped = jnp.int32(0)
        else:
            sw = sort_rows(words)
            send, dropped = _route_sorted(sw, boundaries, D, bucket_cap)
            recv = jax.lax.all_to_all(
                send, AXIS, split_axis=0, concat_axis=0, tiled=True
            )
            batch = recv.reshape(D * bucket_cap, L)
        # keep-dups fold (single-device _merge_keepdups_kernel design): the
        # shard slice stays sorted WITH duplicate rows — one merge instead
        # of the former sort + dedup-compaction re-sort; the distinct count
        # is an adjacency pass and dups compact lazily (host `_dedup_now`)
        if empty:
            # first group of a fresh index: the shard slice is all
            # sentinels — adopt the sorted bucket directly, no merge pass
            # over C sentinel rows
            cols = sort_cols(tuple(batch[:, l] for l in range(L)))
            s = jnp.stack(cols, axis=-1)
            if s.shape[0] < C_new:
                s = jnp.concatenate(
                    [s, jnp.full((C_new - s.shape[0], L), _U32_MAX,
                                 dtype=jnp.uint32)], axis=0
                )
            else:
                s = s[:C_new]
        else:
            d0 = data[0]
            cols = merge_with_unsorted(
                tuple(d0[:, l] for l in range(L)),
                tuple(batch[:, l] for l in range(L)),
            )
            s = jnp.stack(cols, axis=-1)[:C_new]
        prev_eq = jnp.concatenate(
            [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
        )
        distinct = jnp.sum((_valid_mask(s) & ~prev_eq).astype(jnp.int32))
        return (
            s[None],
            distinct[None],
            jax.lax.psum(dropped, AXIS)[None],
        )

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    # donate only when the state buffer can actually be aliased (growth
    # steps change the slice shape and would silently copy + warn)
    return jax.jit(step, donate_argnums=(0,) if C == C_new else ())


@lru_cache(maxsize=None)
def _dedup_fn(cfg: CBLConfig, mesh: Mesh, C: int):
    """Compact the keep-dups shard slices: blank duplicate rows (adjacency)
    and re-sort so live distinct rows are contiguous.  Runs lazily — only
    when capacity pressure or an exactness-requiring consumer (set algebra,
    words_array, checkpoints) demands a clean state."""
    def local(data):
        s = data[0]
        prev_eq = jnp.concatenate(
            [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
        )
        keep = _valid_mask(s) & ~prev_eq
        s = jnp.where(keep[:, None], s, jnp.uint32(0xFFFFFFFF))
        s = sort_rows(s)
        return s[None], jnp.sum(keep.astype(jnp.int32))[None]

    step = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS),),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    return jax.jit(step, donate_argnums=(0,))


@lru_cache(maxsize=None)
def _shard_chunk_fn(mesh: Mesh, cap: int, chunk: int, L: int):
    """jitted ([D, cap, L] data, shard, start) -> [chunk, L] replicated
    block — the chunked-export slice (shard and start traced, one program
    per (cap, chunk))."""
    return jax.jit(
        lambda d, s, i: jax.lax.dynamic_slice(
            d, (s, i, jnp.int32(0)), (1, chunk, L)
        )[0],
        out_shardings=NamedSharding(mesh, P()),
    )


@lru_cache(maxsize=None)
def _repartition_fn(cfg: CBLConfig, mesh: Mesh, C: int, bucket_cap: int):
    """Re-route every stored word to its NEW owner shard in ONE program:
    each shard partitions its (sorted, distinct) slice by the new
    boundaries and exchanges buckets with a single tiled all_to_all.

    Because shard-major order equals global sorted order, the rows a
    destination receives arrive as per-source sorted runs in mesh order —
    already globally sorted up to interspersed sentinel padding — so one
    local sort compacts them.  The distributed analog of re-tuning the
    reference's radix partition from its repartition statistics
    (`/root/reference/src/wordset/mod.rs:254-295`, SURVEY.md §7
    "load-aware prefix partitioning")."""
    D = mesh.devices.size
    L = cfg.word_limbs

    def local(data, boundaries):
        s = data[0]
        send, dropped = _route_sorted(s, boundaries, D, bucket_cap)
        recv = jax.lax.all_to_all(
            send, AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        batch = recv.reshape(D * bucket_cap, L)
        cols = sort_cols(tuple(batch[:, l] for l in range(L)))
        out = jnp.stack(cols, axis=-1)
        if out.shape[0] < C:
            out = jnp.concatenate(
                [out, jnp.full((C - out.shape[0], L), _U32_MAX,
                               dtype=jnp.uint32)], axis=0
            )
        else:
            out = out[:C]
        count = jnp.sum(_valid_mask(out).astype(jnp.int32))
        return (
            out[None],
            count[None],
            jax.lax.psum(dropped, AXIS)[None],
        )

    step = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS), P(AXIS)),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    return jax.jit(step, donate_argnums=(0,))


@lru_cache(maxsize=None)
def _bulk_remove_step_fn(cfg: CBLConfig, canonical: bool, mesh: Mesh,
                         nk_sub: int, C: int, bucket_cap: int):
    """Fused DP front-end + EP routing + per-shard tagged-sort difference —
    the bulk-slab REMOVE (reference contract: remove_batch,
    `/root/reference/src/wordset/mod.rs:218-237`): one device program per
    D*nk_sub k-mers instead of one host dispatch per 2^14-word batch.

    The local fold sorts (word, tag) with batch rows tagged to sort FIRST
    in their equal-word run, so any data row preceded by an equal row is
    removed; duplicate data rows are dropped by the same rule, so the
    output slice is clean (dedup'd + compact)."""
    from ..cbl import _device_words

    D = mesh.devices.size
    L = cfg.word_limbs

    def local_step(data, stream, starts, ends, boundaries):
        words, _ = _device_words(
            stream[0], starts[0], ends[0], nk_sub, cfg, canonical
        )
        if D == 1:
            batch = words
        else:
            sw = sort_rows(words)
            send, _ = _route_sorted(sw, boundaries, D, bucket_cap)
            recv = jax.lax.all_to_all(
                send, AXIS, split_axis=0, concat_axis=0, tiled=True
            )
            batch = recv.reshape(D * bucket_cap, L)
        rows = jnp.concatenate([data[0], batch], axis=0)
        tag = jnp.concatenate(
            [
                jnp.ones((data.shape[1],), jnp.uint32),
                jnp.zeros((batch.shape[0],), jnp.uint32),
            ]
        )
        ops = tuple(rows[:, l] for l in range(L)) + (tag,)
        sorted_ops = sort_cols(ops)
        s = jnp.stack(sorted_ops[:L], axis=-1)
        is_data = sorted_ops[L] == 1
        prev_eq = jnp.concatenate(
            [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
        )
        keep = _valid_mask(s) & is_data & ~prev_eq
        s = jnp.where(keep[:, None], s, jnp.uint32(0xFFFFFFFF))
        s = sort_rows(s)
        return s[None, :C], jnp.sum(keep.astype(jnp.int32))[None]

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    return jax.jit(step, donate_argnums=(0,))


@lru_cache(maxsize=None)
def _bulk_count_step_fn(cfg: CBLConfig, canonical: bool, mesh: Mesh,
                        nk_sub: int, C: int):
    """Fused DP front-end + routed distributed counting query: pipeline on
    the local stream slice, all-to-all to owners, local packed sort-join,
    psum.  Returns (total valid k-mers, positive) per device (replicated)."""
    from ..cbl import _device_words
    from ..wordset import _count_hits_kernel, _count_hits_kernel_packed

    D = mesh.devices.size
    L = cfg.word_limbs
    count_kernel = (
        _count_hits_kernel_packed
        if cfg.n_bits <= 32 * L - 2
        else _count_hits_kernel
    )

    def local_step(data, stream, starts, ends, boundaries):
        words, n_valid = _device_words(
            stream[0], starts[0], ends[0], nk_sub, cfg, canonical
        )
        if D == 1:
            local = count_kernel(data[0], words)
        else:
            sw = sort_rows(words)
            send, _ = _route_sorted(sw, boundaries, D, nk_sub)
            recv = jax.lax.all_to_all(
                send, AXIS, split_axis=0, concat_axis=0, tiled=True
            )
            local = count_kernel(data[0], recv.reshape(D * nk_sub, L))
        return (
            jax.lax.psum(n_valid, AXIS)[None],
            jax.lax.psum(local, AXIS)[None],
        )

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    return jax.jit(step)


@lru_cache(maxsize=None)
def _bulk_contains_step_fn(cfg: CBLConfig, canonical: bool, mesh: Mesh,
                           nk_sub: int, C: int):
    """Fused DP front-end + routed ORDERED membership: every device
    pipelines its stream slice, routes words to owner shards (rank-stable
    bucketing so results can be un-bucketed), joins locally with the
    position-payload sort-join, and routes the hit bits back.  Returns the
    [D, nk_sub] mask in k-mer start order (blanked rows False) — the
    distributed `contains_seq` (`/root/reference/src/cbl.rs:311-324`)."""
    from ..cbl import _device_words
    from ..wordset import _contains_sortjoin_kernel

    D = mesh.devices.size
    L = cfg.word_limbs

    def local_step(data, stream, starts, ends, boundaries):
        words, _ = _device_words(
            stream[0], starts[0], ends[0], nk_sub, cfg, canonical
        )
        if D == 1:
            return _contains_sortjoin_kernel(data[0], words)[None]
        # sorted routing with the k-mer position as payload (no [B, D]
        # one-hot, no scatter — see _contains_step_fn); blanked rows ride
        # to the last shard and join as sentinels -> False
        pos = jnp.arange(nk_sub, dtype=jnp.uint32)
        sc = sort_cols(tuple(words[:, l] for l in range(L)) + (pos,))
        s = jnp.stack(sc[:L], axis=-1)
        send, (ppos,), _ = _route_sorted(
            s, boundaries, D, nk_sub, payload=(sc[L],),
            include_sentinels=True,
        )
        recv = jax.lax.all_to_all(
            send, AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        hits = _contains_sortjoin_kernel(data[0], recv.reshape(D * nk_sub, L))
        back = jax.lax.all_to_all(
            hits.reshape(D, nk_sub), AXIS, split_axis=0, concat_axis=0,
            tiled=True,
        )
        flat_pos = ppos.reshape(D * nk_sub)
        flat_hit = jnp.where(
            flat_pos == _U32_MAX, jnp.uint32(0),
            back.reshape(D * nk_sub).astype(jnp.uint32),
        )
        ordered = sort_cols((flat_pos, flat_hit))[1][:nk_sub]
        return ordered.astype(bool)[None]

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=P(AXIS),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    return jax.jit(step)


@lru_cache(maxsize=None)
def _data_to_slog_fn(mesh: Mesh, C: int, L: int, pack: bool):
    """[D, C, L] sorted shard slices -> ncol COLUMNAR [D, C] tagged slog
    slices (valid rows = implicit seq-0 inserts; packed layout carries
    the tag inside the word limbs, see wordset.slog_packed).  Columnar
    state avoids an interleave/de-interleave transpose of the whole log
    every round and lets the round donate each column buffer."""
    from ..wordset import _data_to_slog_cols

    def local(d):
        return tuple(c[None] for c in _data_to_slog_cols(d[0], pack))

    ncol = L if pack else L + 1
    step = jax.shard_map(
        local, mesh=mesh, in_specs=(P(AXIS),),
        out_specs=(P(AXIS),) * ncol, check_vma=False,
    )
    return jax.jit(step)


@lru_cache(maxsize=None)
def _slog_fold_sharded_fn(cfg: CBLConfig, mesh: Mesh, S: int, C_out: int,
                          pack: bool):
    """Fold each shard's sorted-log columns back to a clean sorted data
    slice (wordset._slog_fold_kernel per shard) + exact distinct counts."""
    from ..wordset import _slog_fold_kernel

    L = cfg.word_limbs
    ncol = L if pack else L + 1

    def local(*slog_cols):
        cols = tuple(c[0] for c in slog_cols)
        data, n_dev = _slog_fold_kernel(cols, C_out, pack)
        return data[None], n_dev[None]

    step = jax.shard_map(
        local, mesh=mesh, in_specs=(P(AXIS),) * ncol,
        out_specs=(P(AXIS), P(AXIS)), check_vma=False,
    )
    return jax.jit(step)


@lru_cache(maxsize=None)
def _sorted_words_fn(cfg: CBLConfig, canonical: bool, mesh: Mesh,
                     nk_sub: int):
    """Per-device pipeline + local sort of one sub-slab group:
    ([D, Sw], [D, S], [D, S]) -> ([D, nk_sub, L] sorted words,
    [D] psum'd valid count).  Memoized per ShardedStream — the sharded
    analog of the PackedStream sorted-words memo."""
    from ..cbl import _device_words

    def local(stream, starts, ends):
        w, nv = _device_words(
            stream[0], starts[0], ends[0], nk_sub, cfg, canonical
        )
        return sort_rows(w)[None], jax.lax.psum(nv, AXIS)[None]

    step = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(AXIS),) * 3, out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,
    )
    return jax.jit(step)


class ShardedStream:
    """A record stream staged for a ShardedCBL: per-device sub-slab
    groups already on the mesh, plus a memo of each group's SORTED word
    slices — repeated passes (a dynamic round querying what an earlier
    round inserted) pay the pipeline and the sort once."""

    def __init__(self, key, groups):
        self.key = key  # (cfg, canonical, mesh id) compatibility check
        self.groups = groups  # [(nk_sub, stream_dev, starts_dev, ends_dev)]
        self._words: dict = {}


@lru_cache(maxsize=None)
def _dyn_round_step_fn(cfg: CBLConfig, mesh: Mesh,
                       nk_i: int, nk_q: int, nk_r: int, S_in: int,
                       S_out: int, cap_b: int):
    """One sharded interleaved dynamic round as ONE device program — the
    distributed analog of `cbl._fused_round_slog_fn` (same tag-sandwich
    semantics, `/root/reference/src/wordset/mod.rs:97-137`):

    every device takes its slice of the three streams' PRE-SORTED words
    (the ShardedStream memo — re-used streams never re-run the pipeline
    or re-sort), tags each with its constant (seq<<2|{1=ins,2=qry,3=rm};
    packed into the word limbs when the config allows), combines them
    with two small merges, routes the combined sorted batch
    to owner shards with ONE all-to-all, re-sorts the received batch,
    merges it into the shard's sorted-log slice with one merge pass,
    and scans once for the round's psum'd hit/live counts.  Round
    3's ShardedCBL paid a full tagged sort of the whole index per op
    here.  Returns (slog [D, S_out, ncol], hits, live, dropped) with the
    scalar outputs replicated per shard."""
    from ..wordset import _shl8_or, slog_counts, slog_packed
    from ..ops.merge import merge_sorted_pair

    D = mesh.devices.size
    L = cfg.word_limbs
    pack = slog_packed(cfg)
    ncol = L if pack else L + 1

    def tagged_cols(words, typ, base):
        sent = words[:, 0] == _U32_MAX
        for l in range(1, L):
            sent = sent & (words[:, l] == _U32_MAX)
        cols = tuple(words[:, l] for l in range(L))
        if pack:
            tag = jnp.where(sent, jnp.uint32(0xFF), jnp.uint32(typ) | base)
            return _shl8_or(cols, tag)
        return cols + (
            jnp.where(sent, _U32_MAX, jnp.uint32(typ) | base),
        )

    def local_step(w_i, w_q, w_r, boundaries, seq, *slog_cols):
        base = seq.astype(jnp.uint32) << 2
        qtag = base | jnp.uint32(2)
        sb = merge_sorted_pair(
            tagged_cols(w_i[0], 1, base),
            tagged_cols(w_q[0], 2, base),
        )
        sb = merge_sorted_pair(sb, tagged_cols(w_r[0], 3, base))
        if D == 1:
            bs = sb
            dropped = jnp.int32(0)
        else:
            bnd = boundaries
            if pack:
                bnd = jnp.stack(
                    _shl8_or(
                        tuple(boundaries[:, l] for l in range(L)),
                        jnp.zeros((boundaries.shape[0],), jnp.uint32),
                    ),
                    axis=-1,
                )
            if pack:
                send, dropped = _route_sorted(
                    jnp.stack(sb, axis=-1), bnd, D, cap_b
                )
                recv = jax.lax.all_to_all(
                    send, AXIS, split_axis=0, concat_axis=0, tiled=True
                ).reshape(D * cap_b, L)
                bs = sort_cols(tuple(recv[:, l] for l in range(L)))
            else:
                send, (ptags,), dropped = _route_sorted(
                    jnp.stack(sb[:L], axis=-1), boundaries, D, cap_b,
                    payload=(sb[L],),
                )
                recv = jax.lax.all_to_all(
                    send, AXIS, split_axis=0, concat_axis=0, tiled=True
                ).reshape(D * cap_b, L)
                rtags = jax.lax.all_to_all(
                    ptags, AXIS, split_axis=0, concat_axis=0, tiled=True
                ).reshape(-1)
                bs = sort_cols(
                    tuple(recv[:, l] for l in range(L)) + (rtags,)
                )
        a_cols = tuple(c[0] for c in slog_cols)
        merged = merge_sorted_pair(a_cols, bs) if S_in else bs
        total = S_in + bs[0].shape[0]
        if total > S_out:
            merged = tuple(c[:S_out] for c in merged)
        elif total < S_out:
            pad = jnp.full((S_out - total,), _U32_MAX, jnp.uint32)
            merged = tuple(jnp.concatenate([c, pad]) for c in merged)
        hits, live = slog_counts(merged, qtag, pack)
        return tuple(c[None] for c in merged) + (
            jax.lax.psum(hits, AXIS)[None],
            jax.lax.psum(live, AXIS)[None],
            jax.lax.psum(dropped, AXIS)[None],
        )

    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(AXIS),) * 3 + (P(), P()) + (P(AXIS),) * ncol,
        out_specs=(P(AXIS),) * (ncol + 3),
        check_vma=False,
    )
    # slog buffers alias only when the round keeps the capacity
    return jax.jit(
        step,
        donate_argnums=tuple(range(5, 5 + ncol)) if S_in == S_out else (),
    )


@lru_cache(maxsize=None)
def _setop_fn(cfg: CBLConfig, mesh: Mesh, op: str, Ca: int, Cb: int, Cout: int):
    """Shard-aligned set algebra: partitions are identical on both operands,
    so every op is purely local per shard (SURVEY.md §2.9).  All four ops
    are ONE tagged streaming sort + adjacency marks + compaction sort —
    intersection/difference included (no random binary-search gathers)."""

    def local(a, b):
        a0, b0 = a[0], b[0]
        cat = jnp.concatenate([a0, b0], axis=0)
        if op == "union":
            s = sort_rows(cat)
            prev_eq = jnp.concatenate(
                [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
            )
            keep = _valid_mask(s) & ~prev_eq
        elif op in ("intersection", "difference"):
            # sort-join: b rows publish their run; keep a rows by run hit
            is_b = jnp.concatenate(
                [
                    jnp.zeros((a0.shape[0],), dtype=bool),
                    jnp.ones((b0.shape[0],), dtype=bool),
                ]
            )
            L = a0.shape[-1]
            cols = tuple(cat[:, l] for l in range(L)) + (
                is_b.astype(jnp.uint32),
            )
            sorted_ops = sort_cols(cols)
            s = jnp.stack(sorted_ops[:L], axis=-1)
            in_b, valid = _sortjoin_hits(sorted_ops[:L], sorted_ops[L] == 1)
            is_a = sorted_ops[L] == 0
            keep = valid & is_a & (in_b if op == "intersection" else ~in_b)
        elif op == "symmetric_difference":
            s = sort_rows(cat)
            prev_eq = jnp.concatenate(
                [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
            )
            next_eq = jnp.concatenate(
                [limbs.eq(s[:-1], s[1:]), jnp.zeros((1,), dtype=bool)]
            )
            keep = _valid_mask(s) & ~prev_eq & ~next_eq
        else:  # pragma: no cover
            raise ValueError(op)
        out, n = _compact(s, keep, Cout)
        return out[None], n[None]

    step = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    return jax.jit(step)


@lru_cache(maxsize=None)
def _union_many_fn(cfg: CBLConfig, mesh: Mesh, Cs: tuple, Cout: int):
    """k-way union in ONE local concat + sort + adjacency dedup per shard
    (vs k-1 pairwise unions = k-1 full sorts) — the distributed analog of
    the reference's k-way heap merge
    (`/root/reference/src/wordset/set_ops.rs:11-42`)."""

    def local(*slices):
        cat = jnp.concatenate([x[0] for x in slices], axis=0)
        s = sort_rows(cat)
        prev_eq = jnp.concatenate(
            [jnp.zeros((1,), dtype=bool), limbs.eq(s[1:], s[:-1])]
        )
        keep = _valid_mask(s) & ~prev_eq
        out, n = _compact(s, keep, Cout)
        return out[None], n[None]

    step = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=tuple(P(AXIS) for _ in Cs),
        out_specs=(P(AXIS), P(AXIS)),
        check_vma=False,  # pallas_call out_shapes carry no vma annotation
    )
    return jax.jit(step)


@lru_cache(maxsize=None)
@lru_cache(maxsize=None)
def _gather_counts_fn(mesh: Mesh):
    """[D] shard-counts (sharded on d) -> [D] fully replicated, so every
    PROCESS of a multi-host mesh can read all counts (np.asarray on a
    sharded global array only sees addressable shards)."""

    def local(counts):
        return jax.lax.all_gather(counts, AXIS, tiled=True)

    return jax.jit(
        jax.shard_map(
            local, mesh=mesh, in_specs=P(AXIS), out_specs=P(),
            check_vma=False,  # all_gather output IS replicated
        )
    )


def build_slab_groups(front, codes: np.ndarray, offsets: np.ndarray,
                      nk_sub: int, rows: int, icap: int | None = None,
                      n_groups: int | None = None):
    """Stack uniform fused sub-slabs into groups of `rows` device inputs.

    Yields (nk_sub, stream [rows, Sw], starts [rows, S], ends [rows, S]);
    missing sub-slabs become all-blank dummies.  `icap` forces the interval
    array length S (multi-process callers need identical shapes on every
    process); `n_groups` pads/truncates the group count the same way."""
    slabs = list(front._fused_slabs(codes, offsets, slab=nk_sub, uniform=True))
    drop = nk_sub + 1
    total_groups = (
        n_groups if n_groups is not None else (len(slabs) + rows - 1) // rows
    )
    sw = None
    for g0 in range(total_groups):
        group = slabs[g0 * rows : (g0 + 1) * rows]
        cap = icap if icap is not None else max(
            (s[2].shape[0] for s in group), default=16
        )
        streams, starts, ends = [], [], []
        for _, stream, s_arr, e_arr, _ in group:
            if len(s_arr) > cap:
                raise ValueError(
                    f"interval cap {cap} < {len(s_arr)} intervals; raise icap"
                )
            s_pad = np.full(cap, drop, dtype=np.int32)
            s_pad[: len(s_arr)] = s_arr
            e_pad = np.full(cap, drop, dtype=np.int32)
            e_pad[: len(e_arr)] = e_arr
            streams.append(stream)
            starts.append(s_pad)
            ends.append(e_pad)
            sw = stream.shape[0]
        while len(streams) < rows:  # dummy all-blank sub-slab
            from ..cbl import _stream_len

            streams.append(
                np.zeros(sw if sw is not None
                         else _stream_len(nk_sub, front.cfg.k) // 16,
                         dtype=np.uint32)
            )
            s_pad = np.full(cap, drop, dtype=np.int32)
            e_pad = np.full(cap, drop, dtype=np.int32)
            s_pad[0], e_pad[0] = 0, nk_sub
            starts.append(s_pad)
            ends.append(e_pad)
        yield nk_sub, np.stack(streams), np.stack(starts), np.stack(ends)


class ShardedCBL:
    """A CBL index partitioned over a 1-D device mesh by word prefix.

    Per-shard state is one sorted sentinel-padded slice (same layout as
    DeviceWordSet.data).  Semantics: the union of shard slices equals the
    single-device index; concatenating shards in mesh order yields the exact
    single-device sorted word order.
    """

    def __init__(
        self,
        k: int = 25,
        prefix_bits: int = 24,
        canonical: bool = False,
        mesh: Mesh | None = None,
        shard_capacity: int = MIN_CAP,
        batch_per_device: int = 1 << 14,
    ):
        from ..config import get_config

        self.cfg = get_config(k=k, prefix_bits=prefix_bits)
        self.canonical = canonical
        self.mesh = mesh if mesh is not None else make_mesh()
        self.D = self.mesh.devices.size  # any size >= 1 (not only pow2)
        self.C = shard_capacity
        self.B = batch_per_device
        self.L = self.cfg.word_limbs
        self.data = self._device_full((self.D, self.C, self.L))
        # Per-shard counts live on device; the host keeps a worst-case upper
        # bound so the insert loop never blocks on a device->host sync
        # (syncing per batch serializes the whole stream).  `shard_counts`
        # materializes lazily.
        self._counts_dev = None
        self._counts_host: np.ndarray | None = np.zeros(self.D, dtype=np.int64)
        # Upper bound of per-shard USED rows: with the keep-dups bulk fold
        # a shard slice may hold duplicate rows beyond its distinct count,
        # so capacity checks track used rows, not counts.
        self._count_upper = 0
        self._dups = False  # shard slices may contain duplicate rows
        # Range-partition boundaries [D-1, L]; default = uniform top-bit
        # splits, replaced by data quantiles on the first insert (necklace
        # distributions are heavily skewed toward small values).
        shard_bits = max((self.D - 1).bit_length(), 0)
        default = [
            (j << (self.cfg.n_bits - shard_bits)) for j in range(1, self.D)
        ]
        self.boundaries = limbs.from_py_ints(default, self.L)
        self._boundaries_from_data = False
        self._dropped_dev = None  # deferred bucket-overflow counter
        # sticky corruption flag: once a bucket overflow dropped words the
        # index is silently incomplete — every later sync/query re-raises
        # until the index is rebuilt (catching the first error must not
        # un-detect the loss)
        self._corrupt = False
        # sharded sorted-log (interleaved dynamic rounds): when active,
        # `_slog_dev` [D, S, L+1] REPLACES `data` as the set representation
        # until `_fold_slog` runs (same contract as DeviceWordSet._slog)
        self._slog_dev = None
        self._slog_seq = 0
        self._slog_real = 0  # per-shard bound on non-sentinel slog rows
        self._slog_live_dev = None  # psum'd distinct count, free per round

    def _maybe_init_boundaries(self, words: np.ndarray) -> None:
        """Derive balanced quantile boundaries from the first word batch."""
        # ordering matters: check the cheap static conditions FIRST —
        # `count()` on an active sorted-log is a blocking device sync, and
        # evaluating it before the D == 1 short-circuit cost every D=1
        # dynamic round a host round trip
        if (self.D == 1 or self._boundaries_from_data
                or self._slog_dev is not None or self._count_upper > 0):
            return
        valid = ~np.all(words == _U32_MAX, axis=-1)
        sample = words[valid]
        if sample.shape[0] < 16 * self.D:
            return  # too small to estimate; keep defaults
        if sample.shape[0] > (1 << 18):
            idx = np.random.default_rng(0).choice(
                sample.shape[0], size=1 << 18, replace=False
            )
            sample = sample[idx]
        order = np.lexsort(tuple(sample[:, l] for l in range(self.L - 1, -1, -1)))
        sample = sample[order]
        qs = [
            sample[(j * sample.shape[0]) // self.D]
            for j in range(1, self.D)
        ]
        self.boundaries = np.stack(qs).astype(np.uint32)
        self._boundaries_from_data = True

    # --- multi-process-safe device array plumbing ---

    @property
    def _sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(AXIS))

    @property
    def _multiproc(self) -> bool:
        return jax.process_count() > 1 and self.mesh.devices.size > len(
            [d for d in self.mesh.devices.flat if d.process_index == jax.process_index()]
        )

    def _device_full(self, shape):
        """Sentinel-filled [D, ...] array sharded on the mesh; created ON
        DEVICE (a host device_put cannot target non-addressable devices of a
        multi-process mesh)."""
        if not self._multiproc:
            return jax.device_put(
                jnp.full(shape, _U32_MAX, dtype=jnp.uint32), self._sharding
            )
        mk = jax.jit(
            lambda: jnp.full(shape, _U32_MAX, dtype=jnp.uint32),
            out_shardings=self._sharding,
        )
        return mk()

    def _put_rows(self, host_rows: np.ndarray):
        """[D, ...] host array -> sharded device array.  In a multi-process
        mesh each process contributes only ITS device rows (the caller
        passes local rows [D_local, ...])."""
        if not self._multiproc:
            return jax.device_put(host_rows, self._sharding)
        return jax.make_array_from_process_local_data(
            self._sharding, np.ascontiguousarray(host_rows)
        )

    # --- word-level ops (device-batched) ---

    @property
    def shard_counts(self) -> np.ndarray:
        """Exact per-shard DISTINCT counts (forces a device sync if one is
        pending).  Only tightens the used-rows bound when the slices are
        known duplicate-free."""
        if self._counts_host is None:
            self._check_dropped()  # surface any deferred overflow first
        return self._counts_nocheck()

    def _counts_nocheck(self) -> np.ndarray:
        """Per-shard counts WITHOUT the overflow check — for internal
        callers that run while a drop counter is legitimately pending
        (capacity growth mid-stream, overflow recovery)."""
        if self._counts_host is None:
            cd = self._counts_dev
            if self._multiproc:
                cd = _gather_counts_fn(self.mesh)(cd)  # replicated [D]
            self._counts_host = np.asarray(cd).astype(np.int64)
            if not self._dups:
                self._count_upper = int(self._counts_host.max())
        return self._counts_host

    @shard_counts.setter
    def shard_counts(self, value) -> None:
        self._counts_host = np.asarray(value).astype(np.int64)
        self._counts_dev = None
        if not self._dups:
            self._count_upper = int(self._counts_host.max())

    def _set_counts_dev(self, counts_dev, upper: int) -> None:
        self._counts_dev = counts_dev
        self._counts_host = None
        self._count_upper = min(upper, self.C)

    def _dedup_now(self) -> None:
        """Compact duplicate rows out of the shard slices (one blank+sort
        pass) and tighten the used-rows bound to the exact counts."""
        fn = _dedup_fn(self.cfg, self.mesh, self.C)
        self.data, counts = fn(self.data)
        self._dups = False
        self._set_counts_dev(counts, self._count_upper)
        self.shard_counts  # sync: used rows == distinct counts now

    def _ensure_clean(self) -> None:
        self._fold_slog()
        if self._dups:
            self._dedup_now()

    # --- sharded sorted-log (interleaved dynamic rounds) ---

    def _fold_slog(self) -> None:
        """Collapse an active sharded sorted-log back into clean `data`
        slices (one scan + compaction sort per shard)."""
        if self._slog_dev is None:
            return
        slog = self._slog_dev
        self._slog_dev = None
        self._slog_seq = 0
        self._slog_live_dev = None
        from ..wordset import slog_packed

        c_out = max(_next_pow2(max(self._slog_real, 1)), MIN_CAP)
        self._slog_real = 0
        fn = _slog_fold_sharded_fn(self.cfg, self.mesh, slog[0].shape[1],
                                   c_out, slog_packed(self.cfg))
        self.data, counts = fn(*slog)
        self.C = c_out
        self._dups = False
        self._set_counts_dev(counts, c_out)

    def pack_stream(self, codes: np.ndarray, offsets: np.ndarray) -> "ShardedStream":
        """Stage a record stream's per-device sub-slab groups on the mesh
        once; dynamic rounds then reuse the staged arrays AND the memo of
        sorted per-device words across rounds (the sharded analog of
        `CBL.pack_stream`)."""
        groups = []
        host0 = None
        for nk_sub, stream, starts, ends in self._sub_slab_groups(
            codes, offsets
        ):
            if host0 is None:
                host0 = (nk_sub, stream, starts, ends)
            groups.append((
                nk_sub,
                self._put_rows(stream),
                self._put_rows(starts),
                self._put_rows(ends),
            ))
        ss = ShardedStream((self.cfg, self.canonical, id(self.mesh)), groups)
        ss._host0 = host0
        return ss

    def _resolve_sharded_stream(self, x) -> "ShardedStream":
        if isinstance(x, ShardedStream):
            if x.key != (self.cfg, self.canonical, id(self.mesh)):
                raise ValueError("ShardedStream built for a different "
                                 "config/mesh")
            return x
        return self.pack_stream(*x)

    def _stream_sorted_words(self, ss: "ShardedStream"):
        """([D, nk, L] sorted per-device words, [D] psum'd valid count)
        of a single-group staged stream, memoized."""
        cached = ss._words.get(0)
        if cached is None:
            nk_sub, stream, starts, ends = ss.groups[0]
            cached = _sorted_words_fn(
                self.cfg, self.canonical, self.mesh, nk_sub
            )(stream, starts, ends)
            ss._words[0] = cached
        return cached

    def dynamic_round(self, ins, qry, rm, lazy: bool = False):
        """One interleaved round over the mesh — insert every k-mer of
        `ins`, count-query `qry` (sees the inserts, not the removes),
        remove every k-mer of `rm` — as ONE sharded device program when
        each stream fits a single sub-slab group (`_dyn_round_step_fn`);
        otherwise the separate bulk calls.  Args are ShardedStreams (see
        `pack_stream`) or (codes, offsets) tuples; returns
        (total, positive)."""
        # stay async at D>1: don't SYNC a pending drop counter here (that
        # would serialize every round on a scalar round trip) — it keeps
        # accumulating on device and the next blocking consumer
        # (count/query/fold/words) runs the real check.  Only the sticky
        # corrupt flag is checked, which is free.
        if self._corrupt:
            self._check_dropped()
        fallback = None
        if not isinstance(ins, ShardedStream) and len(
            list(self._sub_slab_groups(*ins))
        ) != 1:
            fallback = True
        ps_i = self._resolve_sharded_stream(ins)
        ps_q = self._resolve_sharded_stream(qry)
        ps_r = self._resolve_sharded_stream(rm)
        if fallback or any(
            len(p.groups) != 1 for p in (ps_i, ps_q, ps_r)
        ):
            if not (isinstance(ins, tuple) and isinstance(qry, tuple)
                    and isinstance(rm, tuple)):
                raise ValueError(
                    "multi-group dynamic_round needs (codes, offsets) "
                    "tuples (bulk fallback)"
                )
            self.insert_codes_stream(*ins)
            t, p = self.query_codes_stream(*qry)
            self.remove_codes_stream(*rm)
            return t, p
        self._maybe_init_boundaries_from_stream(*ps_i._host0)
        w_i, _ = self._stream_sorted_words(ps_i)
        w_q, nv_q = self._stream_sorted_words(ps_q)
        w_r, _ = self._stream_sorted_words(ps_r)
        nk_i, nk_q, nk_r = (w.shape[1] for w in (w_i, w_q, w_r))
        from ..wordset import _SLOG_SEQ_MAX, _quantize_cap, slog_packed

        if slog_packed(self.cfg) and self._slog_seq >= _SLOG_SEQ_MAX:
            self._fold_slog()  # packed 8-bit tag caps round_seq at 62
        if self._slog_dev is None:
            self._slog_dev = _data_to_slog_fn(
                self.mesh, self.C, self.L, slog_packed(self.cfg)
            )(self.data)
            self._slog_real = min(
                self._count_upper if not self._dups else self.C, self.C
            )
        S_in = self._slog_dev[0].shape[1]
        cap_b = max(
            4096, _next_pow2(max(1, 2 * (nk_i + nk_q + nk_r) // self.D))
        )
        # per-shard growth bound: a shard receives at most D*cap_b padded
        # rows, but only nk_i+nk_q+nk_r REAL (non-sentinel) rows exist in
        # the whole batch — growing by the padded size would inflate
        # _slog_real ~2x+ per round at D>1 and trigger early cap growth
        grow = min(nk_i + nk_q + nk_r, self.D * cap_b)
        new_real = self._slog_real + grow
        S_out = S_in if new_real <= S_in else _quantize_cap(new_real)
        seq = self._slog_seq + 1
        fn = _dyn_round_step_fn(
            self.cfg, self.mesh, nk_i, nk_q, nk_r, S_in, S_out, cap_b,
        )
        out = fn(
            w_i, w_q, w_r, jnp.asarray(self.boundaries), np.uint32(seq),
            *self._slog_dev,
        )
        slog, (hits, live, dropped) = out[:-3], out[-3:]
        self._slog_dev = slog
        self._slog_seq = seq
        self._slog_real = new_real
        self._slog_live_dev = live
        self._counts_host = None
        if self.D > 1:
            self._dropped_dev = (
                dropped if self._dropped_dev is None
                else self._dropped_dev + dropped
            )
        if lazy:
            return nv_q, hits
        t, p = (int(x[0]) for x in jax.device_get((nv_q, hits)))
        return t, p

    def _ensure_capacity(self, incoming_per_shard: int) -> None:
        need = self._count_upper + incoming_per_shard
        if need <= self.C:
            return
        if self._dups:
            # reclaim duplicate rows before paying for a growth pass
            self._dedup_now()
            need = self._count_upper + incoming_per_shard
            if need <= self.C:
                return
        # the upper bound is pessimistic (it assumes every routed word was
        # new and landed on one shard); sync the real counts before paying
        # for a growth pass (no drop check: a counter may legitimately be
        # pending mid-stream — the stream end checks it once)
        need = int(self._counts_nocheck().max()) + incoming_per_shard
        if need <= self.C:
            return
        new_c = max(self.C * 2, 1 << (need - 1).bit_length())
        grow = jax.jit(
            lambda d: jnp.concatenate(
                [
                    d,
                    jnp.full(
                        (self.D, new_c - self.C, self.L),
                        _U32_MAX,
                        dtype=jnp.uint32,
                    ),
                ],
                axis=1,
            ),
            out_shardings=self._sharding,
        )
        self.data = grow(self.data)
        self.C = new_c

    def insert_words(self, words) -> None:
        """words: [N, L] host/device rows (sentinel rows ignored); they are
        split evenly across devices, routed to owners, and merged.  The
        update chain stays async on device; counts sync lazily."""
        self._fold_slog()
        words = np.asarray(words, dtype=np.uint32).reshape(-1, self.L)
        self._maybe_init_boundaries(words)
        B = self.B
        bnd = jnp.asarray(self.boundaries)
        sharding = NamedSharding(self.mesh, P(AXIS))
        for start in range(0, words.shape[0], self.D * B):
            batch = words[start : start + self.D * B]
            buf = np.full((self.D * B, self.L), _U32_MAX, dtype=np.uint32)
            buf[: batch.shape[0]] = batch
            # worst-case: every word in the exchange lands on one shard
            self._ensure_capacity(self.D * B)
            fn = _insert_step_fn(self.cfg, self.mesh, self.C, B)
            dev_words = jax.device_put(buf.reshape(self.D, B, self.L), sharding)
            self.data, counts = fn(self.data, dev_words, bnd)
            self._dups = False  # this fold dedups the whole slice
            self._set_counts_dev(counts, self._count_upper + self.D * B)

    def remove_words(self, words) -> None:
        """Remove [N, L] word rows (sentinel rows and absent words are
        no-ops), routed to owner shards like the insert path."""
        self._fold_slog()
        words = np.asarray(words, dtype=np.uint32).reshape(-1, self.L)
        B = self.B
        bnd = jnp.asarray(self.boundaries)
        sharding = NamedSharding(self.mesh, P(AXIS))
        fn = _remove_step_fn(self.cfg, self.mesh, self.C, B)
        for start in range(0, words.shape[0], self.D * B):
            batch = words[start : start + self.D * B]
            buf = np.full((self.D * B, self.L), _U32_MAX, dtype=np.uint32)
            buf[: batch.shape[0]] = batch
            dev_words = jax.device_put(buf.reshape(self.D, B, self.L), sharding)
            self.data, counts = fn(self.data, dev_words, bnd)
            self._dups = False  # the tagged-sort diff dedups + compacts
            self._set_counts_dev(counts, self._count_upper)

    def contains_words(self, words) -> np.ndarray:
        self._check_dropped()
        self._fold_slog()
        words = np.asarray(words, dtype=np.uint32).reshape(-1, self.L)
        out = []
        B = self.B
        bnd = jnp.asarray(self.boundaries)
        fn = _contains_step_fn(self.cfg, self.mesh, self.C, B)
        sharding = NamedSharding(self.mesh, P(AXIS))
        for start in range(0, words.shape[0], self.D * B):
            batch = words[start : start + self.D * B]
            buf = np.full((self.D * B, self.L), _U32_MAX, dtype=np.uint32)
            buf[: batch.shape[0]] = batch
            dev_words = jax.device_put(buf.reshape(self.D, B, self.L), sharding)
            mask = np.asarray(fn(self.data, dev_words, bnd)).reshape(-1)
            out.append(mask[: batch.shape[0]])
        if not out:
            return np.zeros(0, dtype=bool)
        return np.concatenate(out)

    def count(self) -> int:
        if self._slog_dev is not None and self._slog_live_dev is not None:
            self._check_dropped()
            live = self._slog_live_dev  # psum'd: every shard holds the total
            if self._multiproc:
                return int(np.asarray(live.addressable_shards[0].data)[0])
            return int(np.asarray(live)[0])
        return int(self.shard_counts.sum())

    def count_hits(self, words) -> int:
        """Distributed counting query (sentinel rows ignored)."""
        self._check_dropped()
        self._fold_slog()
        words = np.asarray(words, dtype=np.uint32).reshape(-1, self.L)
        bnd = jnp.asarray(self.boundaries)
        fn = _count_hits_step_fn(self.cfg, self.mesh, self.C, self.B)
        sharding = NamedSharding(self.mesh, P(AXIS))
        B = self.B
        total = 0
        for start in range(0, words.shape[0], self.D * B):
            batch = words[start : start + self.D * B]
            buf = np.full((self.D * B, self.L), _U32_MAX, dtype=np.uint32)
            buf[: batch.shape[0]] = batch
            dev_words = jax.device_put(buf.reshape(self.D, B, self.L), sharding)
            counts = np.asarray(fn(self.data, dev_words, bnd))
            total += int(counts[0])
        return total

    def _resharded_copy(self, other: "ShardedCBL") -> "ShardedCBL":
        """Re-route `other`'s words into a copy aligned to self's partition
        (collective set algebra needs identical boundaries on both sides)."""
        fresh = ShardedCBL(
            k=self.cfg.k,
            prefix_bits=self.cfg.prefix_bits,
            canonical=other.canonical,
            mesh=self.mesh,
            batch_per_device=self.B,
        )
        fresh.boundaries = self.boundaries.copy()
        fresh._boundaries_from_data = True
        rows = other.words_array()
        if rows.shape[0]:
            fresh.insert_words(rows)
        return fresh

    def _binary_op(self, other: "ShardedCBL", op: str) -> "ShardedCBL":
        assert self.cfg == other.cfg and self.canonical == other.canonical
        self._ensure_clean()
        other._ensure_clean()
        if not np.array_equal(self.boundaries, other.boundaries):
            other = self._resharded_copy(other)
        if op in ("union", "symmetric_difference"):
            need = int((self.shard_counts + other.shard_counts).max())
        else:
            need = int(self.shard_counts.max())
        cout = max(MIN_CAP, 1 << max(need - 1, 1).bit_length())
        out = ShardedCBL(
            k=self.cfg.k,
            prefix_bits=self.cfg.prefix_bits,
            canonical=self.canonical,
            mesh=self.mesh,
            shard_capacity=cout,
            batch_per_device=self.B,
        )
        out.boundaries = self.boundaries.copy()
        out._boundaries_from_data = self._boundaries_from_data
        fn = _setop_fn(self.cfg, self.mesh, op, self.C, other.C, cout)
        out.data, counts = fn(self.data, other.data)
        if self._multiproc:
            counts = _gather_counts_fn(self.mesh)(counts)
        out.shard_counts = np.asarray(counts).astype(np.int64)
        return out

    def union(self, other: "ShardedCBL") -> "ShardedCBL":
        return self._binary_op(other, "union")

    def intersection(self, other: "ShardedCBL") -> "ShardedCBL":
        return self._binary_op(other, "intersection")

    def difference(self, other: "ShardedCBL") -> "ShardedCBL":
        return self._binary_op(other, "difference")

    def symmetric_difference(self, other: "ShardedCBL") -> "ShardedCBL":
        return self._binary_op(other, "symmetric_difference")

    __or__ = union
    __and__ = intersection
    __sub__ = difference
    __xor__ = symmetric_difference

    @staticmethod
    def merge_many(sets: list["ShardedCBL"]) -> "ShardedCBL":
        """k-way distributed union: ONE local concat+sort+dedup per shard
        (the reference's k-way heap merge seam,
        `/root/reference/src/wordset/set_ops.rs:11-42`) instead of k-1
        pairwise unions each re-sorting the accumulated result."""
        assert sets
        first = sets[0]
        if len(sets) == 1:
            return first.union(first)  # copy with first's semantics
        aligned = []
        for s in sets:
            assert s.cfg == first.cfg and s.canonical == first.canonical
            s._ensure_clean()
            if not np.array_equal(first.boundaries, s.boundaries):
                s = first._resharded_copy(s)
            aligned.append(s)
        need = int(sum(s.shard_counts for s in aligned).max())
        cout = max(MIN_CAP, 1 << max(need - 1, 1).bit_length())
        out = ShardedCBL(
            k=first.cfg.k,
            prefix_bits=first.cfg.prefix_bits,
            canonical=first.canonical,
            mesh=first.mesh,
            shard_capacity=cout,
            batch_per_device=first.B,
        )
        out.boundaries = first.boundaries.copy()
        out._boundaries_from_data = first._boundaries_from_data
        fn = _union_many_fn(
            first.cfg, first.mesh, tuple(s.C for s in aligned), cout
        )
        out.data, counts = fn(*[s.data for s in aligned])
        if first._multiproc:
            counts = _gather_counts_fn(first.mesh)(counts)
        out.shard_counts = np.asarray(counts).astype(np.int64)
        return out

    @staticmethod
    def intersect_many(sets: list["ShardedCBL"]) -> "ShardedCBL":
        assert sets
        out = sets[0]
        for s in sets[1:]:
            out = out.intersection(s)
        return out

    # --- sequence front-end (reuses the single-chip pipeline) ---

    def _words_of_codes(self, codes: np.ndarray, offsets: np.ndarray):
        from ..cbl import CBL

        front = CBL(
            k=self.cfg.k,
            prefix_bits=self.cfg.prefix_bits,
            canonical=self.canonical,
        )
        valid = front._stream_valid(codes, offsets)
        if len(valid) == 0:
            return
        for words, _, _ in front._stream_words(codes, valid):
            yield np.asarray(words)

    # bulk path: one fused program (pipeline+route+merge) per D sub-slabs
    _SUB_SLAB_MAX = 1 << 24

    def _front(self):
        from ..cbl import CBL

        return CBL(
            k=self.cfg.k,
            prefix_bits=self.cfg.prefix_bits,
            canonical=self.canonical,
        )

    def _sub_slab_groups(self, codes: np.ndarray, offsets: np.ndarray):
        """Yield (nk_sub, stream [D, Sw], starts [D, S], ends [D, S]) groups:
        the record stream is split into D-device groups of uniform fused
        sub-slabs (device d of group g handles k-mer starts
        [(gD+d)*nk_sub, ...)), so every device runs the SAME program on its
        own stream slice — the DP front-end of SURVEY.md §2.9."""
        from ..wordset import _next_pow2

        k = self.cfg.k
        nk = max(len(codes) - k + 1, 0)
        if nk == 0:
            return
        per_dev = (nk + self.D - 1) // self.D
        nk_sub = min(max(_next_pow2(per_dev), 4096), self._SUB_SLAB_MAX)
        yield from build_slab_groups(
            self._front(), codes, offsets, nk_sub, self.D
        )

    def _maybe_init_boundaries_from_stream(
        self, nk_sub: int, stream: np.ndarray, starts: np.ndarray,
        ends: np.ndarray,
    ) -> None:
        """Quantile boundaries from the first sub-slab's words (computed
        once on the default device; ~one extra pipeline pass)."""
        # ordering matters: check the cheap static conditions FIRST —
        # `count()` on an active sorted-log is a blocking device sync, and
        # evaluating it before the D == 1 short-circuit cost every D=1
        # dynamic round a host round trip
        if (self.D == 1 or self._boundaries_from_data
                or self._slog_dev is not None or self._count_upper > 0):
            return
        from ..cbl import _fused_words_fn

        words, _ = _fused_words_fn(self.cfg, self.canonical, nk_sub)(
            stream[0], starts[0], ends[0]
        )
        self._maybe_init_boundaries(np.asarray(words))

    def _insert_group(self, nk_sub: int, stream_g, starts_g, ends_g,
                      bucket_scale: int = 1) -> None:
        """One bulk insert step on already-sharded device inputs.

        Stays fully async: the bucket-overflow counter accumulates on
        device and is checked ONCE per stream (`_check_dropped`) instead
        of forcing a blocking device round-trip per group — the per-group
        sync serialized the whole stream on the high-latency link.
        `bucket_scale` doubles the per-destination routing capacity on
        overflow-recovery retries."""
        bucket_cap = min(
            _next_pow2(nk_sub),  # a source never sends more than its slab
            bucket_scale * max(4096, _next_pow2((2 * nk_sub) // self.D)),
        )
        incoming = min(self.D * nk_sub, self.D * bucket_cap)
        # stay async: only sync exact counts when the pessimistic upper
        # bound says capacity might overflow
        if self._count_upper + incoming > self.C:
            self._ensure_capacity(incoming)
        fn = _bulk_insert_step_fn(
            self.cfg, self.canonical, self.mesh, nk_sub, self.C, self.C,
            bucket_cap, empty=self._count_upper == 0,
        )
        self.data, counts, dropped = fn(
            self.data, stream_g, starts_g, ends_g, jnp.asarray(self.boundaries)
        )
        self._dups = True  # keep-dups fold; compacts lazily
        self._set_counts_dev(counts, self._count_upper + incoming)
        if self.D > 1:
            self._dropped_dev = (
                dropped if self._dropped_dev is None
                else self._dropped_dev + dropped
            )

    def _check_dropped(self) -> None:
        """Verify no routed word overflowed its bucket (one deferred sync
        per insert stream; ~0 drops with quantile boundaries).  Once an
        overflow is seen the index is permanently marked corrupt and every
        later call re-raises — a caller that catches the first error must
        not keep using a silently incomplete index."""
        if self._corrupt:
            raise RuntimeError(
                "sharded index is corrupt: an earlier insert dropped words "
                "on bucket overflow; rebuild the index"
            )
        if self._drops_pending() != 0:
            self._corrupt = True
            raise RuntimeError(
                "sharded insert bucket overflow: range partition too "
                "skewed; rebuild with boundaries from representative data"
            )

    def _drops_pending(self) -> int:
        """Sync and CONSUME the deferred bucket-overflow counter (0 when
        none is pending).  Unlike `_check_dropped` this never marks the
        index corrupt — the insert path uses it to detect an overflow it
        can still recover from (the dropped words are re-insertable)."""
        if self._dropped_dev is None:
            return 0
        d = self._dropped_dev
        self._dropped_dev = None
        return int(np.asarray(d.addressable_shards[0].data)[0]
                   if self._multiproc else np.asarray(d)[0])

    def insert_codes_stream(self, codes: np.ndarray, offsets: np.ndarray) -> None:
        """Distributed bulk build: every device pipelines its own stream
        slice, routes words to owner shards (one all-to-all), and merges
        once per slab group — no per-batch host round-trips."""
        self._fold_slog()
        # Overflow recovery: inserting a word twice is a no-op, so a
        # stream whose routing overflowed a bucket (partition skewed vs
        # the data) is recovered LOSSLESSLY by re-balancing the partition
        # to the current contents (`repartition`) and re-running the whole
        # stream with doubled bucket capacity.  At scale 2^a >= D the
        # bucket holds a full source slab, so the last attempt cannot
        # drop by construction.
        for attempt in range(max(self.D.bit_length(), 1) + 1):
            for nk_sub, stream, starts, ends in self._sub_slab_groups(
                codes, offsets
            ):
                self._maybe_init_boundaries_from_stream(
                    nk_sub, stream, starts, ends
                )
                self._insert_group(
                    nk_sub,
                    self._put_rows(stream),
                    self._put_rows(starts),
                    self._put_rows(ends),
                    bucket_scale=1 << attempt,
                )
            if self.D == 1 or self._drops_pending() == 0:
                if attempt > 0:
                    # the mid-recovery repartition saw only the partial
                    # (biased) survivors; re-balance on the full contents
                    # so the index comes out of recovery healthy
                    self.repartition()
                return
            self.repartition()
        self._corrupt = True  # unreachable: the last attempt cannot drop
        raise RuntimeError("sharded insert dropped words after recovery")

    def remove_codes_stream(self, codes: np.ndarray, offsets: np.ndarray) -> None:
        """Remove every k-mer of the record stream — bulk path: one fused
        pipeline+route+tagged-diff program per slab group (distributed
        analog of `CBL.remove_codes_stream` / reference `remove_seq`,
        `/root/reference/src/wordset/mod.rs:218-237`), replacing the former
        per-2^14-word-batch host loop."""
        self._fold_slog()
        for nk_sub, stream, starts, ends in self._sub_slab_groups(
            codes, offsets
        ):
            self._remove_group(
                nk_sub,
                self._put_rows(stream),
                self._put_rows(starts),
                self._put_rows(ends),
            )

    def _remove_group(self, nk_sub: int, stream_g, starts_g, ends_g) -> None:
        """One bulk remove step on already-sharded device inputs."""
        bucket_cap = max(4096, _next_pow2((2 * nk_sub) // self.D))
        fn = _bulk_remove_step_fn(
            self.cfg, self.canonical, self.mesh, nk_sub, self.C, bucket_cap
        )
        self.data, counts = fn(
            self.data, stream_g, starts_g, ends_g,
            jnp.asarray(self.boundaries),
        )
        self._dups = False  # the tagged-sort diff dedups + compacts
        self._set_counts_dev(counts, self._count_upper)

    def query_codes_stream(self, codes: np.ndarray, offsets: np.ndarray):
        """(total k-mers, positive k-mers) over the record stream — the
        distributed counting query (CLI `query` contract).  One fused
        pipeline+route+join program per slab group; scalars accumulate on
        device and sync once."""
        self._check_dropped()
        self._fold_slog()
        total_dev = positive_dev = None
        for nk_sub, stream, starts, ends in self._sub_slab_groups(
            codes, offsets
        ):
            t, p = self._query_group(
                nk_sub,
                self._put_rows(stream),
                self._put_rows(starts),
                self._put_rows(ends),
            )
            total_dev = t if total_dev is None else total_dev + t
            positive_dev = p if positive_dev is None else positive_dev + p
        if total_dev is None:
            return 0, 0
        return self._reduce_query(total_dev, positive_dev)

    def contains_codes_stream(self, codes: np.ndarray,
                              offsets: np.ndarray) -> list:
        """Per-record ORDERED membership masks over the record stream —
        the distributed `contains_seq` equivalent (one fused
        pipeline+route+join+route-back program per slab group).  Result
        assembly reads every shard's mask, so this entry point is for
        single-process meshes (multi-process callers keep the counting
        query, whose scalars replicate)."""
        self._check_dropped()
        self._fold_slog()
        k = self.cfg.k
        nk = max(len(codes) - k + 1, 0)
        parts = []
        for nk_sub, stream, starts, ends in self._sub_slab_groups(
            codes, offsets
        ):
            fn = _bulk_contains_step_fn(
                self.cfg, self.canonical, self.mesh, nk_sub, self.C
            )
            m = fn(
                self.data,
                self._put_rows(stream),
                self._put_rows(starts),
                self._put_rows(ends),
                jnp.asarray(self.boundaries),
            )
            parts.append(np.asarray(m).reshape(-1))
        flat = (
            np.concatenate(parts)[:nk]
            if parts
            else np.zeros(0, dtype=bool)
        )
        out = []
        for r in range(len(offsets) - 1):
            lo = int(offsets[r])
            hi = max(int(offsets[r + 1]) - k + 1, lo)
            out.append(flat[lo:hi])
        return out

    def contains_seqs(self, seqs) -> list:
        """Ordered membership masks for a sequence batch (distributed
        analog of `CBL.contains_seqs`)."""
        from ..kmer import encode_seq

        codes_list = [
            s if isinstance(s, np.ndarray) and s.dtype == np.uint8
            else encode_seq(s)
            for s in seqs
        ]
        offsets = np.cumsum([0] + [len(c) for c in codes_list],
                            dtype=np.int64)
        codes = (
            np.concatenate(codes_list)
            if codes_list
            else np.zeros(0, dtype=np.uint8)
        )
        return self.contains_codes_stream(codes, offsets)

    def contains_seq(self, seq) -> np.ndarray:
        return self.contains_seqs([seq])[0]

    def _query_group(self, nk_sub: int, stream_g, starts_g, ends_g):
        fn = _bulk_count_step_fn(
            self.cfg, self.canonical, self.mesh, nk_sub, self.C
        )
        return fn(
            self.data, stream_g, starts_g, ends_g, jnp.asarray(self.boundaries)
        )

    def _reduce_query(self, total_dev, positive_dev):
        if self._multiproc:
            t = np.asarray(total_dev.addressable_shards[0].data)
            p = np.asarray(positive_dev.addressable_shards[0].data)
        else:
            t, p = jax.device_get((total_dev, positive_dev))
        return int(np.asarray(t)[0]), int(np.asarray(p)[0])

    @classmethod
    def from_cbl(cls, cbl, mesh: Mesh | None = None, **kw) -> "ShardedCBL":
        """Distribute an existing single-device CBL across the mesh (exact
        same word set; words are routed to their owner shards)."""
        out = cls(
            k=cbl.cfg.k,
            prefix_bits=cbl.cfg.prefix_bits,
            canonical=cbl.canonical,
            mesh=mesh,
            **kw,
        )
        words = cbl.wordset.words_array()
        if words.shape[0]:
            out.insert_words(words)
        return out

    def local_shard_rows(self) -> dict:
        """{global shard id: [count_d, L] live rows} for THIS process's
        addressable shards — multi-process safe (never touches
        non-addressable shards).  Shard-major concatenation across all
        processes equals the global sorted word order."""
        self._ensure_clean()
        counts = self.shard_counts
        out = {}
        for s in self.data.addressable_shards:
            gid = s.index[0].start if s.index[0].start is not None else 0
            out[gid] = np.asarray(s.data)[0, : counts[gid]]
        return out

    def _local_shard_ids(self) -> list[int]:
        """Global mesh positions (along the d axis) of THIS process's
        devices, in addressable-shard order."""
        pid = jax.process_index()
        return [
            i for i, dev in enumerate(self.mesh.devices.flat)
            if dev.process_index == pid
        ]

    @staticmethod
    def _shard_file(path, process_index: int, process_count: int) -> str:
        if process_count == 1:
            return str(path)
        return f"{path}.proc{process_index:05d}-of-{process_count:05d}.npz"

    def save_to_file(self, path) -> None:
        """Sharded checkpoint: each PROCESS writes one npz holding only its
        addressable shards (trimmed to live rows) + the header/boundaries —
        no host gather of non-addressable shards, no single-device re-insert
        (the reference's serde seam, `/root/reference/src/wordset/mod.rs:382-437`,
        re-expressed as sharded array checkpoints per SURVEY.md §5.4).
        Single-process meshes write exactly `path`; multi-process meshes
        write `path.procNNNNN-of-MMMMM` per process."""
        local = self.local_shard_rows()  # cleans + syncs counts
        ids = self._local_shard_ids()
        arrs = {
            "magic": np.frombuffer(b"CBLXSHRD", dtype=np.uint8),
            "k": np.int64(self.cfg.k),
            "prefix_bits": np.int64(self.cfg.prefix_bits),
            "canonical": np.bool_(self.canonical),
            "n_shards": np.int64(self.D),
            "process_count": np.int64(jax.process_count()),
            "boundaries": np.asarray(self.boundaries, dtype=np.uint32),
            "shard_ids": np.asarray(ids, dtype=np.int64),
            "counts": self.shard_counts.astype(np.int64),
        }
        for rank, gid in enumerate(ids):
            arrs[f"rows_{rank}"] = local[gid].astype(np.uint32)
        fname = self._shard_file(
            path, jax.process_index(), jax.process_count()
        )
        with open(fname, "wb") as f:  # file handle: np.savez must not
            np.savez(f, **arrs)       # append .npz to the exact name

    @classmethod
    def load_from_file(cls, path, mesh: Mesh | None = None, **kw) -> "ShardedCBL":
        """Load a sharded checkpoint: each process reads ITS file and
        contributes its shards via make_array_from_process_local_data — no
        process ever materializes the whole index.  The mesh must have the
        same shard count and process placement as at save time (a different
        layout can be produced by loading on the saving layout and
        re-inserting, or via `from_cbl`)."""
        fname = cls._shard_file(path, jax.process_index(), jax.process_count())
        try:
            z = np.load(fname)
        except FileNotFoundError:
            z = np.load(str(path))  # single-file fallback (older format)
        if "magic" not in z or bytes(z["magic"]) != b"CBLXSHRD":
            # single-device cbl_tpu index file: route through from_cbl
            from ..cbl import CBL

            return cls.from_cbl(CBL.load_from_file(path), mesh=mesh, **kw)
        counts = z["counts"].astype(np.int64)
        cap = max(MIN_CAP, 1 << max(int(counts.max()) - 1, 1).bit_length())
        out = cls(
            k=int(z["k"]),
            prefix_bits=int(z["prefix_bits"]),
            canonical=bool(z["canonical"]),
            mesh=mesh,
            shard_capacity=cap,
            **kw,
        )
        if out.D != int(z["n_shards"]):
            raise ValueError(
                f"checkpoint has {int(z['n_shards'])} shards; mesh has {out.D}"
            )
        if int(z["process_count"]) != jax.process_count():
            raise ValueError(
                f"checkpoint written by {int(z['process_count'])} processes; "
                f"running with {jax.process_count()}"
            )
        ids = out._local_shard_ids()
        saved_ids = list(z["shard_ids"])
        if ids != saved_ids:
            raise ValueError(
                f"process owns shards {ids} but checkpoint holds {saved_ids}"
            )
        local = np.full(
            (len(ids), cap, out.L), _U32_MAX, dtype=np.uint32
        )
        for rank, gid in enumerate(ids):
            rows = z[f"rows_{rank}"]
            local[rank, : rows.shape[0]] = rows
        out.data = out._put_rows(local)
        out.boundaries = z["boundaries"]
        out._boundaries_from_data = True
        out.shard_counts = counts
        return out

    def shard_balance(self) -> np.ndarray:
        """Words per shard — the load-balance stat for the prefix partition
        (the distributed analog of the repartition stats, SURVEY.md §5.5)."""
        return self.shard_counts.copy()

    def repartition(self) -> None:
        """Re-balance the range partition to the CURRENT index contents:
        recompute the D-1 global quantile boundaries from the sorted
        shard slices, re-route every stored word to its new owner with
        ONE all_to_all (`_repartition_fn`), and rebuild the per-shard
        counts.  Fixes partitions whose boundaries were frozen from
        early unrepresentative data before later inserts skewed the
        load; `insert_codes_stream` invokes it automatically on bucket
        overflow.  The reference ships repartition statistics precisely
        so its radix partition can be re-tuned
        (`/root/reference/src/wordset/mod.rs:254-295`,
        `/root/reference/examples/cbl.rs:310-366`)."""
        self._fold_slog()
        if self.D == 1:
            return
        if self._dups:
            self._dedup_now()
        counts = self._counts_nocheck()
        total = int(counts.sum())
        if total >= self.D:
            # exact global quantiles: shard-major order IS global sorted
            # order, so rank r lives on the shard whose count prefix-sum
            # covers it — D-1 single-row device reads, ~nothing
            cum = np.concatenate([[0], np.cumsum(counts)])
            ranks = np.array(
                [(j * total) // self.D for j in range(1, self.D)]
            )
            si = (np.searchsorted(cum, ranks, side="right") - 1).astype(
                np.int32
            )
            li = (ranks - cum[si]).astype(np.int32)
            rows = jax.jit(
                lambda d: d[jnp.asarray(si), jnp.asarray(li)],
                out_shardings=NamedSharding(self.mesh, P()),
            )(self.data)
            self.boundaries = np.asarray(jax.device_get(rows)).astype(
                np.uint32
            )
            self._boundaries_from_data = True
        # destination j receives exactly the rank range [r_j, r_{j+1}) —
        # at most ceil(total/D) rows — so no source bucket can exceed it
        bucket_cap = max(4096, _next_pow2(total // self.D + 2))
        fn = _repartition_fn(self.cfg, self.mesh, self.C, bucket_cap)
        self.data, counts_dev, dropped = fn(
            self.data, jnp.asarray(self.boundaries)
        )
        self._dups = False
        n = int(np.asarray(dropped.addressable_shards[0].data)[0]
                if self._multiproc else np.asarray(dropped)[0])
        if n != 0:  # unreachable by the rank-range bound; fail loud
            self._corrupt = True
            raise RuntimeError(f"repartition dropped {n} words (bug)")
        self._set_counts_dev(counts_dev, self._count_upper)

    def to_cbl(self):
        """Gather shards into a single-device CBL (exact same word set)."""
        from ..cbl import CBL

        self._ensure_clean()
        out = CBL(
            k=self.cfg.k,
            prefix_bits=self.cfg.prefix_bits,
            canonical=self.canonical,
        )
        host = np.asarray(self.data)  # [D, C, L]
        rows = [host[d, : self.shard_counts[d]] for d in range(self.D)]
        allrows = np.concatenate(rows) if rows else np.zeros((0, self.L))
        if allrows.shape[0]:
            out.wordset.insert_words(allrows.astype(np.uint32))
            out.wordset.flush()
        return out

    def words_array(self) -> np.ndarray:
        """[n, L] rows in global sorted order (shard-major == sorted)."""
        self._ensure_clean()
        host = np.asarray(self.data)
        rows = [host[d, : self.shard_counts[d]] for d in range(self.D)]
        return (
            np.concatenate(rows)
            if rows
            else np.zeros((0, self.L), dtype=np.uint32)
        )

    def iter_words_chunks(self, chunk_rows: int = 1 << 22):
        """Yield [<=chunk_rows, L] host arrays in GLOBAL sorted order
        (shard-major == sorted) without materialising the whole sharded
        index on host — the multi-device analog of
        `DeviceWordSet.iter_words_chunks`.  Single-process meshes (reads
        every shard's rows)."""
        self._ensure_clean()
        counts = self.shard_counts
        cap = self.C
        chunk = min(chunk_rows, cap)
        slicer = _shard_chunk_fn(self.mesh, cap, chunk, self.L)
        for d in range(self.D):
            nd = int(counts[d])
            if nd == 0:
                continue
            if cap <= chunk_rows:
                yield np.asarray(slicer(self.data, np.int32(d),
                                        np.int32(0)))[:nd]
                continue
            got = 0
            while got < nd:
                start = min(got, cap - chunk)
                block = np.asarray(
                    slicer(self.data, np.int32(d), np.int32(start))
                )
                lo = got - start
                take = min(chunk - lo, nd - got)
                yield block[lo : lo + take]
                got += take
