"""Oracle tests for the plain XLA scans of the hot path: the sorted-log
liveness scan (`wordset.slog_counts`, a cummax) against a numpy
last-write-wins walk, and the record-blank running sum
(`cbl._blank_mask`) against a numpy cumsum mask, across limb widths,
packed and separate tags, and runs that cross large spans."""

import numpy as np
import pytest

import jax.numpy as jnp

from cbl_tpu.wordset import _U32_MAX, slog_counts


def _walk_oracle(cols, qtag, pack=False):
    """(hits, live) by a sequential walk: within each word run, a row is
    live iff the latest insert/remove entry at or before it is an insert
    (reference semantics, `/root/reference/src/wordset/mod.rs:97-137`)."""
    rows = np.stack([np.asarray(c) for c in cols], axis=-1).astype(np.uint64)
    L = rows.shape[1] if pack else rows.shape[1] - 1
    if pack:
        tags = rows[:, L - 1] & 0xFF
        words = rows[:, :L].copy()
        words[:, L - 1] &= ~np.uint64(0xFF)
        tag_max = 0xFF
    else:
        tags = rows[:, L]
        words = rows[:, :L]
        tag_max = 0xFFFFFFFF
    sentinel = np.all(rows[:, :L] == 0xFFFFFFFF, axis=1)
    hits = live = 0
    state = None  # latest entry type in the current run
    n = rows.shape[0]
    for i in range(n):
        if i == 0 or not np.array_equal(words[i], words[i - 1]):
            state = None
        typ = int(tags[i]) & 3
        if typ in (1, 3) and int(tags[i]) != tag_max and not sentinel[i]:
            state = typ
        live_here = state == 1
        if int(tags[i]) == int(qtag) and not sentinel[i] and live_here:
            hits += 1
        run_end = i == n - 1 or not np.array_equal(words[i], words[i + 1])
        if run_end and not sentinel[i] and live_here:
            live += 1
    return hits, live


def _make_slog(rng, n, L, n_words, p_insert=0.6, p_query=0.2, frac_sent=0.1):
    """A (word, tag)-sorted log over few distinct words (long runs) with
    mixed insert/remove/query tags and a sentinel tail."""
    words = np.sort(rng.integers(0, n_words, size=n).astype(np.uint64) * 977)
    limbs = []
    for l in range(L):
        sh = 32 * (L - 1 - l)
        limbs.append(((words >> sh) & 0xFFFFFFFF).astype(np.uint32))
    r = rng.random(n)
    typ = np.where(r < p_insert, 1, np.where(r < p_insert + p_query, 2, 3))
    seq = rng.integers(0, 7, size=n).astype(np.uint32)
    tags = (seq << 2) | typ.astype(np.uint32)
    ns = int(n * frac_sent)
    if ns:
        for lb in limbs:
            lb[-ns:] = 0xFFFFFFFF
        tags[-ns:] = 0xFFFFFFFF
    order = np.lexsort(tuple([tags] + limbs[::-1]))
    return tuple(jnp.asarray(a[order]) for a in (limbs + [tags]))


@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("n", [1024, 4096, 131072])
def test_scan_matches_walk_oracle(L, n):
    rng = np.random.default_rng(L * 100 + n % 97)
    cols = _make_slog(rng, n, L, n_words=max(n // 64, 4))
    for qt in (np.uint32((3 << 2) | 2), np.uint32(_U32_MAX)):
        h, lv = slog_counts(cols, qt)
        assert (int(h), int(lv)) == _walk_oracle(cols, qt)
    assert _walk_oracle(cols, np.uint32(_U32_MAX))[1] > 0  # non-trivial


def test_scan_run_straddles_blocks():
    """One giant run whose liveness flips deep inside: the running max
    must carry the insert marker across the whole run."""
    n = 8192
    c0 = np.zeros(n, np.uint32)
    c1 = np.full(n, 42, np.uint32)
    tags = np.full(n, (1 << 2) | 2, np.uint32)  # queries everywhere
    tags[0] = 1  # seq-0 insert
    tags[5000] = (1 << 2) | 3  # remove later in the run
    tags.sort()
    cols = (jnp.asarray(c0), jnp.asarray(c1), jnp.asarray(tags))
    qt = np.uint32((1 << 2) | 2)
    h, lv = slog_counts(cols, qt)
    assert (int(h), int(lv)) == _walk_oracle(cols, qt)
    assert int(lv) == 0  # the only word's last entry is the remove
    assert int(h) == n - 2  # queries sit between insert and remove


def test_dynamic_round_matches_set_oracle():
    """Fused dynamic rounds (sorted log + scan) against a Python set: the
    positives see the round's inserts but not its removes; the free live
    count and a fold agree."""
    from cbl_tpu import CBL

    rng = np.random.default_rng(33)
    codes = rng.integers(0, 4, size=12_000, dtype=np.uint8)
    off = np.array([0, 6_000], dtype=np.int64)
    k = 25

    def kmers(c):
        return {bytes(c[i:i + k]) for i in range(len(c) - k + 1)}

    rounds = [
        (codes[:6000], codes[:6000], codes[3000:9000]),
        (codes[6000:], codes[:6000], codes[:6000]),
    ]
    idx = CBL(k=k)
    want = set()
    for ins, qry, rm in rounds:
        got = idx.dynamic_round((ins, off), (qry, off), (rm, off))
        want |= kmers(ins)
        q = [bytes(qry[i:i + k]) for i in range(len(qry) - k + 1)]
        assert got == (len(q), sum(x in want for x in q))
        want -= kmers(rm)
        assert idx.count() == len(want)
    idx.wordset.flush()
    assert idx.count() == len(want)


def test_slog_count_and_join_match_walk_oracle():
    """The jitted users of the scan: the distinct-live count and the
    query join against an unfolded log."""
    from cbl_tpu.wordset import _slog_count_kernel, _slog_join_count

    rng = np.random.default_rng(7)
    cols = _make_slog(rng, 4096, 2, n_words=50)
    assert int(_slog_count_kernel(cols)) == _walk_oracle(cols, _U32_MAX)[1]
    words = np.stack([np.asarray(c) for c in cols[:2]], axis=-1)[::7]
    q = np.concatenate([words, np.full((3, 2), 0xFFFFFFFF, np.uint32)])
    got = int(_slog_join_count(cols, jnp.asarray(q)))
    qt = np.full(len(q), 0xFFFFFFFF, np.uint32)
    merged = [np.concatenate([np.asarray(c), x])
              for c, x in zip(cols, (q[:, 0], q[:, 1], qt))]
    order = np.lexsort(merged[::-1])
    want = _walk_oracle(tuple(m[order] for m in merged), _U32_MAX)[0]
    assert got == want > 0


@pytest.mark.parametrize("n", [1024, 65536])
def test_scan_packed_layout(n):
    """Packed-tag layout (tag in the low 8 bits of the last limb): run
    grouping must ignore the tag bits."""
    from cbl_tpu.wordset import _shl8_or

    rng = np.random.default_rng(n)
    L = 2
    words = np.sort(rng.integers(0, n // 16, size=n).astype(np.uint64) * 131)
    c0 = (words >> 32).astype(np.uint32)
    c1 = (words & 0xFFFFFFFF).astype(np.uint32)
    typ = rng.choice([1, 2, 3], size=n).astype(np.uint32)
    seq = rng.integers(0, 8, size=n).astype(np.uint32)
    tag = (seq << 2) | typ
    ns = n // 8
    c0[-ns:] = 0xFFFFFFFF
    c1[-ns:] = 0xFFFFFFFF
    tag[-ns:] = 0xFF
    packed = np.stack(
        [np.asarray(x) for x in _shl8_or(
            (jnp.asarray(c0), jnp.asarray(c1)), jnp.asarray(tag))],
        axis=-1,
    )
    order = np.lexsort((packed[:, 1], packed[:, 0]))
    cols = tuple(jnp.asarray(packed[order, l].copy()) for l in range(L))
    qt = np.uint32((3 << 2) | 2)
    want = _walk_oracle(cols, qt, pack=True)
    h, lv = slog_counts(cols, qt, pack=True)
    assert (int(h), int(lv)) == want
    assert want[1] > 0


@pytest.mark.parametrize("n", [1024, 4096, 131072])
def test_blank_mask_matches_cumsum(n):
    """The record-blank running sum equals a numpy cumsum mask for random
    overlapping intervals, with ends at and past the array's end."""
    from cbl_tpu.cbl import _blank_mask

    rng = np.random.default_rng(n)
    n_iv = 37
    starts = rng.integers(0, n, size=n_iv).astype(np.int32)
    lens = rng.integers(1, max(n // 8, 2), size=n_iv).astype(np.int32)
    ends = np.minimum(starts + lens, n).astype(np.int32)
    delta = np.zeros(n + 1, np.int64)
    np.add.at(delta, starts, 1)
    np.add.at(delta, ends, -1)
    want = np.cumsum(delta)[:n] > 0
    pad = np.full(5, n + 1, np.int32)  # padding entries are dropped
    mask, nv = _blank_mask(jnp.asarray(np.concatenate([starts, pad])),
                           jnp.asarray(np.concatenate([ends, pad])), n)
    np.testing.assert_array_equal(np.asarray(mask), want)
    assert int(nv) == int((~want).sum())
    assert want.any() and not want.all()


def test_device_words_blank_records():
    """The fused slab pipeline blanks exactly the k-mers that span a
    record boundary or start in the padded tail, and counts the rest."""
    from cbl_tpu import CBL
    import cbl_tpu.cbl as cmod

    rng = np.random.default_rng(77)
    codes = rng.integers(0, 4, size=9_000, dtype=np.uint8)
    offsets = np.array([0, 1_000, 1_024, 5_000, 9_000], dtype=np.int64)
    idx = CBL(k=25)
    ps = idx.pack_stream(codes, offsets)
    nk_pad, stream, s_arr, e_arr, n_here = ps.slabs[0]
    w, nv = cmod._fused_words_fn(idx.cfg, False, nk_pad)(stream, s_arr, e_arr)
    valid = idx._stream_valid(codes, offsets)
    want = np.zeros(nk_pad, bool)
    want[: len(valid)] = valid
    got = ~np.all(np.asarray(w) == 0xFFFFFFFF, axis=1)
    np.testing.assert_array_equal(got, want)
    assert int(nv) == int(valid.sum())
