"""Merges and sorts of multi-limb column tuples (`cbl_tpu.ops.merge`).

Every merge case runs on both routes a merge can take: the Pallas merge
kernel (`ops/merge_triton.py`, interpret mode here) and `lax.sort` of the
concatenation.  Both must equal `lax.sort(concat)` bit for bit.  Small
tiles force many programs, misaligned co-ranks and windows that reach the
arrays' ends.  Sorts are checked against `np.lexsort`; the dispatch's
choice of route is checked with the backend patched."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cbl_tpu.ops import merge, merge_triton

IMPLS = ["kernel", "lax"]


def _merge(impl, a, b, t_log=10):
    a = tuple(jnp.asarray(c) for c in a)
    b = tuple(jnp.asarray(c) for c in b)
    if impl == "kernel":
        return merge_triton.merge_sorted_cols(a, b, t_log=t_log,
                                              interpret=True)
    return merge.sort_cols(jnp.concatenate([x, y]) for x, y in zip(a, b))


def _oracle(a, b):
    cat = tuple(jnp.concatenate([jnp.asarray(x), jnp.asarray(y)])
                for x, y in zip(a, b))
    out = jax.lax.sort(cat, num_keys=len(cat))
    return out if isinstance(out, tuple) else (out,)


def _check(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _sorted_cols(n, seed, L=2, lo=0, hi=1 << 16, sent_frac=0.04):
    r = np.random.default_rng(seed)
    cols = [r.integers(lo, hi, size=n).astype(np.uint32) for _ in range(L)]
    sent = r.random(n) < sent_frac
    for c in cols:
        c[sent] = 0xFFFFFFFF
    order = np.lexsort(tuple(cols[::-1]))
    return tuple(c[order] for c in cols)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("na_log,nb_log,t_log", [
    (12, 12, 10), (13, 11, 10), (14, 14, 11), (12, 10, 12),
])
@pytest.mark.parametrize("L", [1, 2, 3])
def test_merge_matches_sorted_concat(impl, na_log, nb_log, t_log, L):
    ca = _sorted_cols(1 << na_log, na_log * 13 + L, L=L)
    cb = _sorted_cols(1 << nb_log, nb_log * 7 + L, L=L)
    _check(_merge(impl, ca, cb, t_log), _oracle(ca, cb))


@pytest.mark.parametrize("impl", IMPLS)
def test_merge_heavy_duplicates(impl):
    """Long equal runs straddling tile boundaries stress the co-rank tie
    rule (A before B) and the in-tile ranks."""
    ca = _sorted_cols(1 << 12, 1, L=2, hi=7, sent_frac=0.1)
    cb = _sorted_cols(1 << 12, 2, L=2, hi=7, sent_frac=0.1)
    _check(_merge(impl, ca, cb), _oracle(ca, cb))


@pytest.mark.parametrize("impl", IMPLS)
def test_merge_skewed_sides(impl):
    """One side far smaller than the other (the insert-batch shape), with
    lengths that are not tile multiples."""
    ca = _sorted_cols((1 << 14) + 5, 3, L=2)
    cb = _sorted_cols(3 * (1 << 8), 4, L=2)
    _check(_merge(impl, ca, cb), _oracle(ca, cb))
    _check(_merge(impl, cb, ca), _oracle(cb, ca))


@pytest.mark.parametrize("impl", IMPLS)
def test_merge_payload_column(impl):
    """An int32 payload rides as a tie-break key (the sort-join pattern)."""
    rng = np.random.default_rng(5)
    Na = Nb = 1 << 11
    ka = np.sort(rng.integers(0, 64, size=Na).astype(np.uint32))
    kb = np.sort(rng.integers(0, 64, size=Nb).astype(np.uint32))
    pa = np.arange(Na, dtype=np.int32)
    pb = np.arange(Nb, dtype=np.int32) + Na
    oa = np.lexsort((pa, ka))
    ob = np.lexsort((pb, kb))
    a, b = (ka[oa], pa[oa]), (kb[ob], pb[ob])
    _check(_merge(impl, a, b), _oracle(a, b))


@pytest.mark.parametrize("impl", IMPLS)
def test_cbl_end_to_end(impl, request):
    """Whole stack with every merge on one route: build + growth insert
    + query + export equal a Python-set oracle."""
    from cbl_tpu import CBL

    if impl == "kernel":
        request.getfixturevalue("kernel_route")
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = bytes(bases[rng.integers(0, 4, 3000)])
    seq2 = bytes(bases[rng.integers(0, 4, 2000)])
    idx = CBL(k=25)
    idx.insert_seq(seq)
    idx.insert_seq(seq2)
    want = {seq[i:i + 25] for i in range(len(seq) - 24)}
    want |= {seq2[i:i + 25] for i in range(len(seq2) - 24)}
    assert idx.count() == len(want)
    assert bool(idx.contains_seq(seq).all())
    assert {bytes(x) for x in idx.iter_nucs()} == want
    u = idx | idx
    assert u.count() == len(want)


@pytest.mark.parametrize("impl", IMPLS)
def test_stream_query_and_rounds(impl, request):
    """Stream build, a self-query through the sorted-words memo (both
    sides sorted: one merge, no query sort), and two dynamic rounds (the
    second merges into a non-empty log); counts match a set oracle."""
    from cbl_tpu import CBL

    if impl == "kernel":
        request.getfixturevalue("kernel_route")
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, size=4000, dtype=np.uint8)
    off = np.array([0, len(codes)], dtype=np.int64)
    idx = CBL(k=25)
    ps = idx.pack_stream(codes, off)
    idx.insert_codes_stream(ps)
    n_dev = idx.count_device()
    total_dev, pos_dev = idx.query_codes_stream(ps, lazy=True)
    n, t, p = (int(x) for x in jax.device_get((n_dev, total_dev, pos_dev)))
    assert ps._words[0][2] is True  # memo holds sorted rows
    nk = len(codes) - 24
    assert t == nk and p == nk
    assert n == len({codes[i:i + 25].tobytes() for i in range(nk)})

    dyn = CBL(k=25)
    assert dyn.dynamic_round((codes, off), (codes, off), (codes, off)) == (
        nk, nk)
    assert dyn.count() == 0
    assert dyn.dynamic_round((codes, off), (codes, off),
                             (codes[:2000], np.array([0, 2000]))) == (nk, nk)
    assert dyn.count() == len(
        {codes[i:i + 25].tobytes() for i in range(nk)}
        - {codes[i:i + 25].tobytes() for i in range(2000 - 24)}
    )


@pytest.mark.parametrize("L", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1000, 4096, 65537])
def test_sort_matches_lexsort(L, n):
    """Multi-key sorts over L = 1..4 uint32 columns with duplicates and
    all-ones sentinel rows, which must sort last."""
    rng = np.random.default_rng(n * 10 + L)
    cols = [rng.integers(0, 7, size=n).astype(np.uint32) for _ in range(L)]
    sent = rng.random(n) < 0.05
    for c in cols:
        c[sent] = 0xFFFFFFFF
    got = merge.sort_cols(jnp.asarray(c) for c in cols)
    order = np.lexsort(tuple(cols[::-1]))
    for g, c in zip(got, cols):
        np.testing.assert_array_equal(np.asarray(g), c[order])
    assert np.all(np.asarray(got[0])[-int(sent.sum()):] == 0xFFFFFFFF)


def test_sort_wide_values_and_payload():
    """Full-range uint32 limbs with long equal prefixes, and an int32
    payload column as the minor key."""
    rng = np.random.default_rng(0)
    N = 1 << 13
    hi = rng.integers(0, 1 << 32, size=N, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=N, dtype=np.uint64).astype(np.uint32)
    hi[: N // 2] = hi[N // 2:]
    pay = rng.permutation(N).astype(np.int32)
    got = merge.sort_cols((jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(pay)))
    order = np.lexsort((pay, lo, hi))
    for g, c in zip(got, (hi, lo, pay)):
        np.testing.assert_array_equal(np.asarray(g), c[order])


@pytest.mark.parametrize("backend,n,want", [
    ("cpu", 1 << 24, False),
    ("gpu", merge.MERGE_KERNEL_MIN_N - 1, False),
    ("gpu", merge.MERGE_KERNEL_MIN_N, True),
    ("gpu", 1 << 24, True),
])
def test_merge_route(monkeypatch, backend, n, want):
    """The kernel runs only on a GPU backend and from the measured floor
    up; every other merge is lax.sort of the concatenation."""
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(merge_triton, "merge_sorted_cols",
                        lambda a, b: calls.append(len(a)) or a + b)
    assert merge.use_merge_kernel(n) is want
    jax.clear_caches()  # the route is chosen while tracing
    a = (jnp.zeros((n // 2,), jnp.uint32),)
    b = (jnp.ones((n - n // 2,), jnp.uint32),)
    jax.eval_shape(merge.merge_sorted_pair, a, b)
    jax.eval_shape(merge.merge_with_unsorted, a, b)
    assert calls == ([1, 1] if want else [])


@pytest.mark.gpu
def test_merge_kernel_on_gpu(gpu):
    """The compiled kernel at real widths equals lax.sort(concat)."""
    from cbl_tpu.ops.kernel_checks import merge_kernel_check

    for L, na, nb in ((2, 1 << 22, 1 << 22), (4, 1 << 20, 3 << 18)):
        assert merge_kernel_check(L, na, nb, reps=1)["ok"]
