"""DeviceWordSet vs a host python-set oracle, mirroring the reference's
wordset tests (`/root/reference/src/wordset/mod.rs:439-533`,
`src/wordset/set_ops.rs:412-836` which use a HashSet oracle)."""

import numpy as np
import pytest

from cbl_tpu import limbs
from cbl_tpu.config import get_config
from cbl_tpu.wordset import DeviceWordSet

CFG = get_config(k=25, prefix_bits=24)  # n_bits=56, L=2


def _rows(values):
    return limbs.from_py_ints(list(values), CFG.word_limbs)


def _rand_words(rng, n):
    return [int(x) for x in rng.integers(0, 1 << CFG.n_bits, size=n, dtype=np.uint64)]


def test_insert_contains_remove_even_odd():
    # even/odd family as in `src/wordset/mod.rs:451-475`
    n = 20_000
    evens = list(range(0, 2 * n, 2))
    odds = list(range(1, 2 * n, 2))
    ws = DeviceWordSet(CFG, pending_cap=1 << 14)
    rng = np.random.default_rng(0)
    perm = rng.permutation(n)
    ws.insert_words(_rows([evens[i] for i in perm]))
    assert ws.count() == n
    assert bool(np.all(np.asarray(ws.contains_words(_rows(evens)))))
    assert not np.any(np.asarray(ws.contains_words(_rows(odds))))
    ws.remove_words(_rows(evens))
    assert ws.count() == 0
    assert ws.is_empty()


def test_duplicates_and_sentinel_rows():
    ws = DeviceWordSet(CFG)
    vals = [5, 5, 7, 7, 7, 9]
    rows = _rows(vals)
    sent = np.full((3, CFG.word_limbs), 0xFFFFFFFF, dtype=np.uint32)
    ws.insert_words(np.concatenate([rows, sent]))
    assert ws.count() == 3
    got = limbs.to_py_ints(ws.words_array())
    assert got == [5, 7, 9]


def test_pending_buffer_flush_boundary():
    ws = DeviceWordSet(CFG, pending_cap=256)
    all_vals = set()
    rng = np.random.default_rng(1)
    for _ in range(10):
        vals = _rand_words(rng, 100)
        all_vals.update(vals)
        ws.insert_words(_rows(vals))
    assert ws.count() == len(all_vals)
    assert limbs.to_py_ints(ws.words_array()) == sorted(all_vals)


def test_oversized_batch():
    ws = DeviceWordSet(CFG, pending_cap=64)
    rng = np.random.default_rng(2)
    vals = _rand_words(rng, 1000)
    ws.insert_words(_rows(vals))
    assert ws.count() == len(set(vals))


def test_growth_across_capacities():
    ws = DeviceWordSet(CFG, pending_cap=2048)
    rng = np.random.default_rng(3)
    ref = set()
    for _ in range(8):
        vals = _rand_words(rng, 2000)
        ref.update(vals)
        ws.insert_words(_rows(vals))
        ws.flush()
    assert ws.count() == len(ref)
    assert limbs.to_py_ints(ws.words_array()) == sorted(ref)


def test_remove_partial():
    rng = np.random.default_rng(4)
    vals = list(set(_rand_words(rng, 5000)))
    ws = DeviceWordSet(CFG)
    ws.insert_words(_rows(vals))
    victims = vals[::3]
    ws.remove_words(_rows(victims))
    ref = sorted(set(vals) - set(victims))
    assert limbs.to_py_ints(ws.words_array()) == ref
    # removing absent words is a no-op
    ws.remove_words(_rows(victims))
    assert ws.count() == len(ref)


@pytest.mark.parametrize("op", ["union", "intersection", "difference", "symmetric_difference"])
def test_set_algebra_oracle(op):
    rng = np.random.default_rng(5)
    a_vals = set(int(x) for x in rng.integers(0, 4000, size=3000))
    b_vals = set(int(x) for x in rng.integers(0, 4000, size=3000))
    a = DeviceWordSet(CFG)
    b = DeviceWordSet(CFG)
    a.insert_words(_rows(sorted(a_vals)))
    b.insert_words(_rows(sorted(b_vals)))
    got = getattr(a, op)(b)
    expect = sorted(getattr(a_vals, op)(b_vals))
    assert limbs.to_py_ints(got.words_array()) == expect
    # operands unchanged
    assert a.count() == len(a_vals)
    assert b.count() == len(b_vals)


def test_kway_merge_associativity():
    # `/root/reference/src/wordset/set_ops.rs:721-836`
    rng = np.random.default_rng(6)
    fams = [set(_rand_words(rng, 500)) for _ in range(5)]
    sets = []
    for fam in fams:
        ws = DeviceWordSet(CFG)
        ws.insert_words(_rows(sorted(fam)))
        sets.append(ws)
    merged = DeviceWordSet.merge_many(sets)
    expect = sorted(set().union(*fams))
    assert limbs.to_py_ints(merged.words_array()) == expect
    inter = DeviceWordSet.intersect_many(sets)
    expect_i = sorted(set.intersection(*fams))
    assert limbs.to_py_ints(inter.words_array()) == expect_i


def test_radix_vs_binary_search_paths():
    import os

    from cbl_tpu.wordset import _contains_kernel

    rng = np.random.default_rng(7)
    vals = list(set(_rand_words(rng, 8000)))
    ws = DeviceWordSet(CFG)
    ws.insert_words(_rows(vals))
    queries = _rows(vals[:2000] + _rand_words(rng, 2000))
    got_radix = np.asarray(ws.contains_words(queries))
    ws.flush()
    got_binary = np.asarray(_contains_kernel(ws.data, jnp_asarray(queries)))
    np.testing.assert_array_equal(got_radix, got_binary)
    assert got_radix[:2000].all()


def jnp_asarray(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def test_radix_fallback_on_giant_bucket():
    # all words share the same top table_bits -> one bucket > 1024 -> the
    # bucket path must refuse and fall back to binary search
    ws = DeviceWordSet(CFG)
    base = 1 << (CFG.n_bits - CFG.word_limbs * 0 - 30)  # small words, same top bits
    vals = list(range(2000))
    ws.insert_words(_rows(vals))
    assert not ws._ensure_radix_index() or ws._window <= 1024
    got = np.asarray(ws.contains_words(_rows([5, 4999])))
    assert got.tolist() == [True, False]


def test_contains_on_empty():
    ws = DeviceWordSet(CFG)
    assert not np.any(np.asarray(ws.contains_words(_rows([1, 2, 3]))))
    assert ws.count() == 0


def test_insert_rows_bulk_multi_batch():
    # bulk path: many batches folded in one merge, duplicates across batches
    ws = DeviceWordSet(CFG)
    rng = np.random.default_rng(7)
    batches, oracle = [], set()
    for _ in range(5):
        vals = _rand_words(rng, 1000) + [42, 43]  # cross-batch duplicates
        oracle.update(vals)
        batches.append(jnp_asarray(_rows(vals)))
    ws.insert_rows_bulk(batches)
    assert ws.count() == len(oracle)
    assert limbs.to_py_ints(ws.words_array()) == sorted(oracle)
    # second bulk overlapping the first (merge into non-empty live index)
    vals2 = _rand_words(rng, 1500) + list(sorted(oracle)[:500])
    oracle.update(vals2)
    ws.insert_rows_bulk([jnp_asarray(_rows(vals2))])
    assert ws.count() == len(oracle)
    assert limbs.to_py_ints(ws.words_array()) == sorted(oracle)
    # bulk of nothing is a no-op
    ws.insert_rows_bulk([])
    assert ws.count() == len(oracle)


def test_bulk_then_remove_then_query():
    ws = DeviceWordSet(CFG)
    rng = np.random.default_rng(8)
    vals = _rand_words(rng, 4000)
    oracle = set(vals)
    ws.insert_rows_bulk([jnp_asarray(_rows(vals))])
    gone = vals[:1000]
    oracle -= set(gone)
    ws.remove_words(_rows(gone))
    assert ws.count() == len(oracle)
    keep = sorted(oracle)
    mask = np.asarray(ws.contains_words(_rows(keep + gone[:50])))
    assert mask[: len(keep)].all()
    # removed words may coincide with kept ones only if duplicated in vals
    for i, g in enumerate(gone[:50]):
        assert bool(mask[len(keep) + i]) == (g in oracle)


def test_live_slice_tracks_shrink_and_growth():
    # data allocation must track content: after a big build + count sync,
    # later small merges must not re-sort the old high-water allocation
    ws = DeviceWordSet(CFG)
    rng = np.random.default_rng(9)
    ws.insert_rows_bulk([jnp_asarray(_rows(_rand_words(rng, 60_000)))])
    n1 = ws.count()
    big_shape = ws.data.shape[0]
    assert big_shape <= 2 * 65536
    ws.insert_words(_rows(_rand_words(rng, 10)))
    ws.flush()
    assert ws.data.shape[0] <= max(2 * big_shape, 65536 * 2)
    assert ws.count() >= n1


def test_interleaved_log_oracle():
    """Interleaved insert/remove/query vs a python-set oracle: removes are
    lazy log entries (no fold per op) and point queries see the log's
    last-write-wins state without forcing a fold."""
    ws = DeviceWordSet(CFG)
    rng = np.random.default_rng(10)
    oracle = set()
    universe = _rand_words(rng, 3000)
    for step in range(12):
        ins = [universe[i] for i in rng.integers(0, len(universe), 200)]
        rem = [universe[i] for i in rng.integers(0, len(universe), 120)]
        ws.insert_words(_rows(ins))
        oracle.update(ins)
        ws.remove_words(_rows(rem))
        oracle.difference_update(rem)
        probes = [universe[i] for i in rng.integers(0, len(universe), 64)]
        got = np.asarray(ws.contains_words(_rows(probes)))
        want = np.array([p in oracle for p in probes])
        assert (got == want).all(), f"step {step}"
        if step % 5 == 4:  # fold mid-stream and re-check
            assert ws.count() == len(oracle)
    assert ws.count() == len(oracle)
    assert limbs.to_py_ints(ws.words_array()) == sorted(oracle)


def test_log_reinsert_after_remove():
    ws = DeviceWordSet(CFG)
    vals = [10, 20, 30, 40]
    ws.insert_words(_rows(vals))
    ws.remove_words(_rows([20, 30]))
    ws.insert_words(_rows([30]))  # re-insert after pending remove
    got = np.asarray(ws.contains_words(_rows(vals)))
    assert list(got) == [True, False, True, True]
    assert ws.count() == 3
    # remove of an absent word is a no-op; remove after fold also works
    ws.remove_words(_rows([999]))
    ws.remove_words(_rows([10]))
    assert ws.count() == 2
    assert limbs.to_py_ints(ws.words_array()) == [30, 40]


@pytest.mark.parametrize(
    "op", ["union", "intersection", "difference", "symmetric_difference"]
)
def test_set_algebra_merge_path_forced(op, kernel_route):
    """The one-pass merge set-op kernels (union -> dups state, marking ops
    -> holes state; engaged on a GPU from the merge floor up) must match
    the python-set oracle exactly, including count before any compaction
    and operand preservation."""
    rng = np.random.default_rng(8)
    a_vals = set(int(x) for x in rng.integers(0, 3000, size=2200))
    b_vals = set(int(x) for x in rng.integers(0, 3000, size=2200))
    a = DeviceWordSet(CFG)
    b = DeviceWordSet(CFG)
    a.insert_words(_rows(sorted(a_vals)))
    b.insert_words(_rows(sorted(b_vals)))
    got = getattr(a, op)(b)
    assert got._dups or got._holes  # the merge path actually ran
    expect = sorted(getattr(a_vals, op)(b_vals))
    assert got.count() == len(expect)  # count correct pre-compaction
    assert limbs.to_py_ints(got.words_array()) == expect
    assert a.count() == len(a_vals)
    assert b.count() == len(b_vals)
    # the lazy-state result composes: op again with a fresh operand
    got2 = got.union(b)
    assert got2.count() == len(set(expect) | b_vals)


def test_single_limb_packed_setops_ignore_sentinels():
    """L=1 configs: the packed-tag shift must keep sentinel pads inert in
    every set-op kernel (a 1-limb all-ones row shifted left lost its
    sentinel-ness and union/symdiff emitted a garbage 0x7FFFFFFF word)."""
    import jax.numpy as jnp

    from cbl_tpu.wordset import (
        _setop_merge_kernel,
        _setop_sort_kernel_packed,
    )

    a = np.full((8, 1), 0xFFFFFFFF, np.uint32)
    a[:3, 0] = [2, 5, 9]
    b = np.full((8, 1), 0xFFFFFFFF, np.uint32)
    b[:2, 0] = [5, 11]
    cases = [("union", {2, 5, 9, 11}), ("inter", {5}), ("diff", {2, 9}),
             ("symdiff", {2, 9, 11})]
    for op, want in cases:
        out, n = _setop_sort_kernel_packed(
            jnp.asarray(a), jnp.asarray(b), op, 16
        )
        got = {int(x) for x in np.asarray(out)[:, 0] if x != 0xFFFFFFFF}
        assert got == want and int(n) == len(want), (op, got, int(n))
    for op, want in cases[1:]:
        out, n = _setop_merge_kernel(jnp.asarray(a), jnp.asarray(b), op)
        got = {int(x) for x in np.asarray(out)[:, 0] if x != 0xFFFFFFFF}
        assert got == want and int(n) == len(want), (op, got, int(n))


def test_slog_packed_boundary_configs_cannot_reach_sentinel():
    """Configs whose packed row is fully occupied (n_bits + 8 == 32*L,
    e.g. K=25) could collide the all-ones word + 0xFF query tag with the
    sentinel; slog_packed proves the all-ones word unreachable (the pos
    field can never saturate for odd K) via an assert.  Sweep every valid
    config and exercise that proof."""
    from cbl_tpu.config import CBLConfig
    from cbl_tpu.wordset import slog_packed

    boundary = 0
    for k in range(3, 60, 2):
        for pb in range(1, min(2 * k, 33)):
            cfg = CBLConfig(k=k, prefix_bits=pb)
            packed = slog_packed(cfg)  # must not raise
            if cfg.n_bits + 8 == 32 * cfg.word_limbs:
                boundary += 1
                assert packed
                assert (1 << cfg.pos_bits) - 1 >= 2 * k
    assert boundary > 0  # the K=25 flagship family is in the sweep


def test_iter_words_chunks_matches_words_array():
    """Chunked export yields the exact words_array content in order, in
    bounded chunk-sized host pieces (round-4 verdict item 6; the
    reference iterates lazily, /root/reference/src/wordset/mod.rs:
    298-362), including the clamped final block."""
    import tracemalloc

    from cbl_tpu.cbl import CBL

    rng = np.random.default_rng(1)
    n = 1 << 20
    rows = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
    rows[:, 0] &= (1 << 24) - 1
    idx = CBL(k=25)
    idx.wordset.insert_words(rows)
    idx.wordset.flush()
    full = idx.wordset.words_array()
    chunk = 1 << 16
    tracemalloc.start()
    parts = []
    for w in idx.wordset.iter_words_chunks(chunk):
        assert w.shape[0] <= chunk
        parts.append(w)
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert len(parts) >= full.shape[0] // chunk  # actually chunked
    np.testing.assert_array_equal(np.concatenate(parts), full)
    # host-side allocations stay bounded (the concatenate above is the
    # test's own; the generator itself copies at most ~chunk rows/step)
    assert peak < 4 * full.nbytes, (peak, full.nbytes)


def test_iter_words_chunks_small_and_empty():
    from cbl_tpu.cbl import CBL

    idx = CBL(k=25)
    assert list(idx.wordset.iter_words_chunks()) == []
    idx.insert_seq(b"ACGTACGTACGTACGTACGTACGTACGTA")
    chunks = list(idx.wordset.iter_words_chunks(1 << 16))
    assert len(chunks) == 1 and chunks[0].shape[0] == idx.count()
