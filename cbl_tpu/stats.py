"""Repartition / load statistics.

Parity with `/root/reference/src/wordset/mod.rs:254-295` and the CLI
`repartition` report (`/root/reference/examples/cbl.rs:310-366`).  These
stats exist to tune PREFIX_BITS and are exactly what's needed to measure
shard balance for the multi-chip partition (SURVEY.md §5.5).

Node counts reproduce the reference's structural accounting
(`src/trievec/mod.rs:37-42`, `src/trie.rs:90-102`): a bucket of size
<= 1024 is a "vec" whose node count is its length; a larger bucket is a
256-ary trie whose node count is 1 (root) + the number of distinct
big-endian byte-prefixes of its suffixes at depths 1..BYTES-1.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

THRESHOLD = 1024  # `/root/reference/src/wordset/mod.rs:34`


def _bucket_boundaries(prefixes: np.ndarray):
    """Sorted [n] prefixes -> (unique_prefixes, start_offsets incl. end)."""
    if len(prefixes) == 0:
        return np.zeros(0, dtype=np.uint32), np.zeros(1, dtype=np.int64)
    change = np.nonzero(np.diff(prefixes))[0] + 1
    starts = np.concatenate([[0], change, [len(prefixes)]])
    return prefixes[starts[:-1]], starts


def prefix_load(cbl) -> float:
    """`/root/reference/src/wordset/mod.rs:253-256`."""
    uniq, _ = _bucket_boundaries(cbl.wordset.prefixes())
    return len(uniq) / float(1 << cbl.cfg.prefix_bits)


def buckets_sizes(cbl):
    """Iterator of (prefix, bucket_size); `src/wordset/mod.rs:258-263`."""
    uniq, starts = _bucket_boundaries(cbl.wordset.prefixes())
    sizes = np.diff(starts)
    return list(zip((int(p) for p in uniq), (int(s) for s in sizes)))


def buckets_size_count(cbl) -> dict[int, int]:
    """`src/wordset/mod.rs:265-271` (BTreeMap -> sorted dict)."""
    _, starts = _bucket_boundaries(cbl.wordset.prefixes())
    sizes = np.diff(starts)
    return dict(sorted(Counter(int(s) for s in sizes).items()))


def buckets_load_repartition(cbl) -> dict[int, float]:
    """`src/wordset/mod.rs:273-280`."""
    sc = buckets_size_count(cbl)
    total = sum(s * c for s, c in sc.items())
    return {s: (s * c) / total for s, c in sc.items()}


def _suffix_path_bytes(cbl) -> np.ndarray:
    """[n, BYTES] big-endian suffix bytes of every stored word (the trie
    path order of `src/trie.rs`; SlicedInt bytes reversed)."""
    cfg = cbl.cfg
    words = cbl.wordset.words_array()
    n = words.shape[0]
    nbytes = (cfg.suffix_bits + 7) // 8
    if n == 0:
        return np.zeros((0, nbytes), dtype=np.uint8)
    # Big-endian byte view of each row's limbs; suffix = low SUFFIX_BITS bits.
    wb = np.ascontiguousarray(words.astype(">u4")).view(np.uint8).reshape(n, -1)
    path = wb[:, wb.shape[1] - nbytes :].copy()
    top_bits = cfg.suffix_bits - 8 * (nbytes - 1)
    if top_bits < 8:
        path[:, 0] &= (1 << top_bits) - 1
    return path


def buckets_nodes(cbl):
    """Iterator of (prefix, node_count); `src/wordset/mod.rs:282-287`."""
    uniq, starts = _bucket_boundaries(cbl.wordset.prefixes())
    path = _suffix_path_bytes(cbl)
    nbytes = path.shape[1]
    out = []
    for i, p in enumerate(uniq):
        lo, hi = starts[i], starts[i + 1]
        size = int(hi - lo)
        if size <= THRESHOLD:
            out.append((int(p), size))
            continue
        seg = path[lo:hi]
        nodes = 1  # root
        for depth in range(1, nbytes):
            # suffixes are sorted, so distinct prefixes = 1 + #adjacent changes
            changed = np.any(seg[1:, :depth] != seg[:-1, :depth], axis=1)
            nodes += 1 + int(np.count_nonzero(changed))
        out.append((int(p), nodes))
    return out


def buckets_node_count(cbl) -> dict[int, int]:
    """`src/wordset/mod.rs:289-295`."""
    return dict(sorted(Counter(n for _, n in buckets_nodes(cbl)).items()))


def shard_balance(cbl, num_shards: int) -> np.ndarray:
    """Words owned by each prefix-space shard (new multi-device stat:
    measures skew of the multi-chip partition, SURVEY.md §2.9)."""
    prefixes = cbl.wordset.prefixes()
    shard_bits = max((num_shards - 1).bit_length(), 0)
    owners = prefixes >> np.uint32(cbl.cfg.prefix_bits - shard_bits)
    return np.bincount(owners.astype(np.int64), minlength=num_shards)
