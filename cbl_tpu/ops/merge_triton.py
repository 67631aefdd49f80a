"""Merge of two sorted column tuples on an NVIDIA GPU (Pallas, Triton route).

Every fold into a non-empty index, every dynamic round and the set-algebra
merges combine two runs that are each sorted already (wordset.py).  A
`lax.sort` of their concatenation makes many full passes over device
memory; a merge needs about one.  The merge here is merge-path:

1. (XLA) co-rank partition: for each output tile boundary g*T, a
   vectorized binary search along the merge-path diagonal finds how many
   rows of A (`ai[g]`) and of B (`g*T - ai[g]`) precede it, A before B on
   ties.  Output tile g is then exactly the merge of the windows
   A[ai[g]:ai[g+1]] and B[bi[g]:bi[g+1]], whose lengths sum to T.
2. (Pallas, one program per output tile) each program loads its two
   windows with coalesced masked loads and ranks every row against the
   other window by a branch-free binary search: an A row counts the B rows
   strictly below it (lower bound), a B row the A rows at or below it
   (upper bound), comparing lexicographically over all columns.  Each row
   is stored at g*T + its own index + its rank.

The comparator treats every column as a key (column 0 most significant),
so full-row ties are identical rows and the output equals
`lax.sort(concat, num_keys=len(cols))` bit for bit.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..limbs import cols_le, cols_lt

DEFAULT_T_LOG = 10  # output rows per program
NUM_WARPS = 4


def coranks(cols_a, cols_b, diags):
    """ai[j] = number of A rows among the first diags[j] merged rows (A
    before B on ties): the smallest i with not A[i] <= B[d-i-1]."""
    na = cols_a[0].shape[0]
    nb = cols_b[0].shape[0]
    d = diags.astype(jnp.int32)
    lo = jnp.maximum(0, d - nb)
    hi = jnp.minimum(d, na)

    # unrolled (static trip count), so XLA fuses the search into one kernel
    for _ in range(int(na).bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        a_row = tuple(c[jnp.clip(mid, 0, na - 1)] for c in cols_a)
        b_row = tuple(c[jnp.clip(d - mid - 1, 0, nb - 1)] for c in cols_b)
        pred = cols_le(a_row, b_row)
        lo = jnp.where(active & pred, mid + 1, lo)
        hi = jnp.where(active & ~pred, mid, hi)
    return lo


@lru_cache(maxsize=None)
def _merge_call(dtypes: tuple, na: int, nb: int, t_log: int,
                interpret: bool):
    L = len(dtypes)
    T = 1 << t_log
    n = na + nb
    G = -(-n // T)

    def kernel(ai_ref, *refs):
        a_refs, b_refs, o_refs = refs[:L], refs[L:2 * L], refs[2 * L:]
        g = pl.program_id(0)
        d0 = g * T
        a0 = ai_ref[g]
        a1 = ai_ref[g + 1]
        b0 = d0 - a0
        len_a = a1 - a0
        len_b = jnp.minimum(d0 + T, n) - a1 - b0
        i = jnp.arange(T, dtype=jnp.int32)
        in_a = i < len_a
        in_b = i < len_b
        a = [plt.load(r.at[pl.ds(a0, T)], mask=in_a, other=0)
             for r in a_refs]
        b = [plt.load(r.at[pl.ds(b0, T)], mask=in_b, other=0)
             for r in b_refs]
        rank_a = jnp.zeros((T,), jnp.int32)
        rank_b = jnp.zeros((T,), jnp.int32)
        step = T // 2
        while step:
            # candidate counts; a row with a valid partner window never
            # needs more than T - 1 (the windows' lengths sum to T)
            ca = rank_a + step
            ok_a = in_a & (ca <= len_b)
            ia = jnp.minimum(b0 + ca - 1, nb - 1)
            pb = [plt.load(r.at[ia], mask=ok_a, other=0) for r in b_refs]
            rank_a = jnp.where(ok_a & cols_lt(pb, a), ca, rank_a)
            cb = rank_b + step
            ok_b = in_b & (cb <= len_a)
            ib = jnp.minimum(a0 + cb - 1, na - 1)
            pa = [plt.load(r.at[ib], mask=ok_b, other=0) for r in a_refs]
            rank_b = jnp.where(ok_b & cols_le(pa, b), cb, rank_b)
            step //= 2
        # masked-off lanes point past the end (never written)
        pos_a = jnp.where(in_a, d0 + i + rank_a, n)
        pos_b = jnp.where(in_b, d0 + i + rank_b, n)
        for l in range(L):
            plt.store(o_refs[l].at[pos_a], a[l], mask=in_a)
            plt.store(o_refs[l].at[pos_b], b[l], mask=in_b)

    return pl.pallas_call(
        kernel,
        grid=(G,),
        out_shape=[jax.ShapeDtypeStruct((n,), dt) for dt in dtypes],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name=f"merge_sorted_l{L}",
    )


def merge_sorted_cols(cols_a, cols_b, t_log: int = DEFAULT_T_LOG,
                      interpret: bool = False):
    """Merge two column tuples that are each sorted ascending (every
    column a key, lexicographic) into one sorted tuple of |a| + |b| rows;
    equals `lax.sort(concat, num_keys=len(cols))` exactly."""
    cols_a = tuple(cols_a)
    cols_b = tuple(cols_b)
    na, nb = cols_a[0].shape[0], cols_b[0].shape[0]
    if na == 0 or nb == 0:
        return cols_b if na == 0 else cols_a
    T = 1 << t_log
    G = -(-(na + nb) // T)
    diags = jnp.minimum(jnp.arange(G + 1, dtype=jnp.int32) * T, na + nb)
    ai = coranks(cols_a, cols_b, diags)
    dtypes = tuple(jnp.dtype(c.dtype) for c in cols_a)
    run = _merge_call(dtypes, na, nb, t_log, interpret)
    return tuple(run(ai, *cols_a, *cols_b))
