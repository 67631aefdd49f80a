"""Necklace kernel vs brute-force oracle, mirroring
`/root/reference/src/necklace/mod.rs:33-99`."""

import jax.numpy as jnp
import numpy as np
import pytest

from cbl_tpu import kmer, limbs, necklace
from cbl_tpu.config import get_config


def _random_kmers(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    vals = [int(rng.integers(0, 1 << 30)) for _ in range(n)]
    # widen to full kmer_bits range
    vals = [
        (v * 0x9E3779B97F4A7C15 ^ (v << 7)) & ((1 << cfg.kmer_bits) - 1) for v in vals
    ]
    return vals, limbs.from_py_ints(vals, cfg.kmer_limbs)


@pytest.mark.parametrize("k", [5, 25, 29, 59])
def test_necklace_matches_bruteforce(k):
    cfg = get_config(k=k, prefix_bits=min(24, 2 * k - 1))
    vals, arr = _random_kmers(cfg, 300, seed=k)
    best, pos = necklace.necklace_pos(arr, cfg)
    best = limbs.to_py_ints(np.asarray(best))
    pos = np.asarray(pos)
    for i, v in enumerate(vals):
        eb, ep = necklace.py_necklace_pos(v, cfg.kmer_bits)
        assert best[i] == eb, f"value {i}"
        assert pos[i] == ep, f"pos {i}"


@pytest.mark.parametrize("k", [25, 59])
def test_necklace_revert_roundtrip(k):
    cfg = get_config(k=k, prefix_bits=24)
    vals, arr = _random_kmers(cfg, 300, seed=100 + k)
    best, pos = necklace.necklace_pos(arr, cfg)
    back = np.asarray(necklace.revert_necklace_pos(best, pos, cfg))
    np.testing.assert_array_equal(back, arr)


def test_periodic_words():
    # `/root/reference/src/necklace/mod.rs:83-98`: periodic words edge case
    cfg = get_config(k=15, prefix_bits=24)  # kmer_bits=30
    rng = np.random.default_rng(9)
    vals = []
    for _ in range(200):
        half = int(rng.integers(0, 1 << 15))
        vals.append((half << 15) | half)  # period-15 word in 30 bits
    arr = limbs.from_py_ints(vals, cfg.kmer_limbs)
    best, pos = necklace.necklace_pos(arr, cfg)
    best = limbs.to_py_ints(np.asarray(best))
    pos = np.asarray(pos)
    for i, v in enumerate(vals):
        eb, ep = necklace.py_necklace_pos(v, cfg.kmer_bits)
        assert (best[i], pos[i]) == (eb, ep)


@pytest.mark.parametrize("k", [25, 59])
def test_pack_unpack_word(k):
    cfg = get_config(k=k, prefix_bits=24)
    vals, arr = _random_kmers(cfg, 200, seed=5)
    best, pos = necklace.necklace_pos(arr, cfg)
    word = necklace.pack_word(best, pos, cfg)
    wvals = limbs.to_py_ints(np.asarray(word))
    bvals = limbs.to_py_ints(np.asarray(best))
    for i in range(len(vals)):
        assert wvals[i] == (bvals[i] << cfg.pos_bits) | int(np.asarray(pos)[i])
    n2, p2 = necklace.unpack_word(word, cfg)
    np.testing.assert_array_equal(np.asarray(n2), np.asarray(best))
    np.testing.assert_array_equal(np.asarray(p2), np.asarray(pos))
    km = np.asarray(necklace.word_to_kmer(word, cfg))
    np.testing.assert_array_equal(km, arr)


def test_word_prefix():
    cfg = get_config(k=25, prefix_bits=24)
    vals, arr = _random_kmers(cfg, 100, seed=11)
    best, pos = necklace.necklace_pos(arr, cfg)
    word = necklace.pack_word(best, pos, cfg)
    pref = np.asarray(necklace.word_prefix(word, cfg))
    for w, p in zip(limbs.to_py_ints(np.asarray(word)), pref):
        assert (w >> cfg.suffix_bits) == int(p)


@pytest.mark.parametrize("k", [25, 59])
def test_necklace_chain_jitted_batch(k):
    """The jitted rotation chain over a slab-style batch (the shape the
    fused pipeline compiles) against the pure-python definition, with the
    top bits of every word set."""
    import jax

    cfg = get_config(k=k, prefix_bits=24 if k == 25 else 28)
    rng = np.random.default_rng(3)
    vals = [int(rng.integers(0, 1 << 30)) | (int(rng.integers(0, 1 << 30))
            << (cfg.kmer_bits - 30)) for _ in range(1024)]
    arr = limbs.from_py_ints(vals, cfg.kmer_limbs)
    best, pos = jax.jit(lambda x: necklace.necklace_pos(x, cfg))(arr)
    got_best = limbs.to_py_ints(np.asarray(best))
    for v, b, p in zip(vals, got_best, np.asarray(pos)):
        assert (b, int(p)) == necklace.py_necklace_pos(v, cfg.kmer_bits)


@pytest.mark.parametrize("k", [5, 25, 59])
def test_necklace_kernel_matches_chain(k):
    """The GPU kernel (interpret mode) against the XLA chain and the
    python oracle, with a partial last block."""
    from cbl_tpu.ops.necklace_triton import necklace_pos_kernel

    cfg = get_config(k=k, prefix_bits=4 if k == 5 else 24)
    vals, arr = _random_kmers(cfg, 300, seed=k)
    best, pos = necklace_pos_kernel(jnp.asarray(arr), cfg.kmer_bits,
                                    block_log=6, interpret=True)
    want_best, want_pos = necklace.necklace_chain(jnp.asarray(arr),
                                                  cfg.kmer_bits)
    np.testing.assert_array_equal(np.asarray(best), np.asarray(want_best))
    np.testing.assert_array_equal(np.asarray(pos), np.asarray(want_pos))
    got = limbs.to_py_ints(np.asarray(best))
    for v, b, p in zip(vals[:40], got, np.asarray(pos)):
        assert (b, int(p)) == necklace.py_necklace_pos(v, cfg.kmer_bits)


@pytest.mark.parametrize("backend,kernel", [("gpu", True), ("cpu", False)])
def test_necklace_route(monkeypatch, backend, kernel):
    """`necklace_pos` takes the kernel on a GPU backend, the chain
    elsewhere."""
    import jax

    from cbl_tpu.ops import necklace_triton

    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(necklace_triton, "necklace_pos_kernel",
                        lambda x, w: calls.append(w) or (x, x[:, 0]))
    cfg = get_config(k=25, prefix_bits=24)
    jax.eval_shape(lambda x: necklace.necklace_pos(x, cfg),
                   jax.ShapeDtypeStruct((64, cfg.kmer_limbs), jnp.uint32))
    assert calls == ([cfg.kmer_bits] if kernel else [])


@pytest.mark.gpu
def test_necklace_kernel_on_gpu(gpu):
    """The compiled kernel at slab width equals the XLA chain."""
    from cbl_tpu.ops.kernel_checks import necklace_kernel_check

    for width, L in ((50, 2), (118, 4)):
        assert necklace_kernel_check(width, L, 1 << 22, reps=1)["ok"]


@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_column_comparators_match_tuple_order(L):
    """`limbs.cols_lt` / `cols_le` (shared by both Pallas kernels) and
    `limbs.lt` order rows as Python compares the tuples of their limbs;
    few distinct values per limb force ties in every column."""
    rng = np.random.default_rng(L)
    a = rng.integers(0, 3, size=(512, L)).astype(np.uint32)
    b = rng.integers(0, 3, size=(512, L)).astype(np.uint32)
    a[::7, -1] = 0xFFFFFFFF  # the top of the range compares too
    ca = [jnp.asarray(a[:, l]) for l in range(L)]
    cb = [jnp.asarray(b[:, l]) for l in range(L)]
    want_lt = [tuple(x) < tuple(y) for x, y in zip(a.tolist(), b.tolist())]
    want_le = [tuple(x) <= tuple(y) for x, y in zip(a.tolist(), b.tolist())]
    assert np.asarray(limbs.cols_lt(ca, cb)).tolist() == want_lt
    assert np.asarray(limbs.cols_le(ca, cb)).tolist() == want_le
    assert np.asarray(limbs.lt(jnp.asarray(a), jnp.asarray(b))).tolist() \
        == want_lt
