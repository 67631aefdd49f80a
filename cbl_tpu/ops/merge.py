"""Sorting and merging of multi-limb uint32 column tuples.

Every hot kernel of the word-set store funnels into a sort or a merge of
uint32 key columns (build folds, query joins, set algebra, sorted-log
rounds; see wordset.py).  Sorts are `lax.sort` with every column a key.
Merges of two runs that are each sorted take the Pallas merge kernel
(`merge_triton.py`) on a GPU once the combined length reaches
`MERGE_KERNEL_MIN_N`, and `lax.sort` of the concatenation otherwise.  Both
routes give the same rows bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Smallest combined row count at which a merge takes the kernel: on an H100
# the kernel beat lax.sort(concat) at L = 2, 3 and 4 from 2^15 rows up, and
# below that both cost about one launch (PERF.md, PR 1).
MERGE_KERNEL_MIN_N = 1 << 15


def sort_cols(cols):
    """`lax.sort(cols, num_keys=len(cols))`, always returning a tuple."""
    cols = tuple(cols)
    out = jax.lax.sort(cols, num_keys=len(cols))
    return out if isinstance(out, tuple) else (out,)


def use_merge_kernel(n_total: int) -> bool:
    """True when a merge of n_total rows runs the GPU merge kernel.
    Callers also use it to pick merge-friendly state layouts (contiguous
    operands for the one-pass set operations) only when they pay."""
    return jax.default_backend() == "gpu" and n_total >= MERGE_KERNEL_MIN_N


def merge_sorted_pair(sorted_a, sorted_b):
    """Merge two column tuples that are each sorted ascending into one
    sorted tuple; equals `lax.sort(concat, num_keys=all)`."""
    a = tuple(sorted_a)
    b = tuple(sorted_b)
    if use_merge_kernel(a[0].shape[0] + b[0].shape[0]):
        from .merge_triton import merge_sorted_cols

        return merge_sorted_cols(a, b)
    return sort_cols(jnp.concatenate([x, y]) for x, y in zip(a, b))


def merge_with_unsorted(sorted_cols, unsorted_cols):
    """Combine a sorted column tuple with an unsorted one into one sorted
    tuple; equals `lax.sort(concat, num_keys=all)`.  On the kernel route
    only the unsorted side is sorted before the merge."""
    a = tuple(sorted_cols)
    b = tuple(unsorted_cols)
    if use_merge_kernel(a[0].shape[0] + b[0].shape[0]):
        return merge_sorted_pair(a, sort_cols(b))
    return sort_cols(jnp.concatenate([x, y]) for x, y in zip(a, b))
