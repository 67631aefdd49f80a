"""On-device checks of the hand-written kernels against their plain XLA
references (merge: `lax.sort` of the concatenation; necklace: the XLA
chain), at the widths the engine runs them.  `chip_smoke.py` and the
`gpu`-marked tests call these; both need the card the kernel compiles for.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from .. import necklace
from ..limbs import width_mask
from .merge import sort_cols
from .merge_triton import merge_sorted_cols
from .necklace_triton import necklace_pos_kernel


def _sorted_random_cols(key, n: int, L: int):
    """L uint32 columns of n random rows, sorted lexicographically, made on
    the device (host sorts at 2^28 rows take minutes)."""
    cols = jax.random.bits(key, (L, n), jnp.uint32)
    return sort_cols(tuple(cols))


def _median_seconds(fn, args, reps: int):
    out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def merge_kernel_check(L: int, na: int, nb: int, reps: int = 5,
                       seed: int = 0, interpret: bool = False) -> dict:
    """Merge two sorted random runs of na and nb rows over L columns with
    the compiled kernel and with `lax.sort` of the concatenation; returns
    whether they agree bit for bit and each one's median time (ms).
    interpret=True runs the kernel in Pallas interpret mode (rehearsal on
    a CPU; its times mean nothing)."""
    ka, kb = jax.random.split(jax.random.PRNGKey(seed))
    a = jax.jit(_sorted_random_cols, static_argnums=(1, 2))(ka, na, L)
    b = jax.jit(_sorted_random_cols, static_argnums=(1, 2))(kb, nb, L)
    kernel = jax.jit(lambda a, b: merge_sorted_cols(a, b,
                                                    interpret=interpret))
    plain = jax.jit(lambda a, b: sort_cols(
        jnp.concatenate([x, y]) for x, y in zip(a, b)))
    t_kernel, got = _median_seconds(kernel, (a, b), reps)
    ok = all(bool(jnp.array_equal(g, w))
             for g, w in zip(got, jax.block_until_ready(plain(a, b))))
    del got
    t_plain, _ = _median_seconds(plain, (a, b), reps)
    return {"L": L, "na": na, "nb": nb, "ok": ok,
            "kernel_ms": t_kernel * 1e3, "lax_sort_ms": t_plain * 1e3}


def necklace_kernel_check(width: int, L: int, n: int, reps: int = 5,
                          seed: int = 0, interpret: bool = False) -> dict:
    """Necklaces of n random `width`-bit k-mers (L limbs) with the compiled
    kernel and with the XLA chain; returns whether they agree bit for bit
    and each one's median time (ms)."""
    x = jax.random.bits(jax.random.PRNGKey(seed), (n, L), jnp.uint32)
    x = x & jnp.asarray(width_mask(width, L))
    kernel = jax.jit(lambda x: necklace_pos_kernel(x, width,
                                                   interpret=interpret))
    plain = jax.jit(lambda x: necklace.necklace_chain(x, width))
    t_kernel, got = _median_seconds(kernel, (x,), reps)
    want = jax.block_until_ready(plain(x))
    ok = all(bool(jnp.array_equal(g, w)) for g, w in zip(got, want))
    del got, want
    t_plain, _ = _median_seconds(plain, (x,), reps)
    return {"width": width, "n": n, "ok": ok,
            "kernel_ms": t_kernel * 1e3, "chain_ms": t_plain * 1e3}
