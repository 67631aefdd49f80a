"""Necklace (smallest cyclic rotation) of a batch of k-mers on an NVIDIA
GPU (Pallas, Triton route).

`necklace.necklace_pos` is a chain of 2K - 1 rotate/compare/select steps
over each k-mer's limbs.  XLA splits that chain into about two kernels per
step on a GPU, each reading and writing the (rot, best, pos) carry in
device memory.  Here one program takes a block of k-mers, keeps the carry
in registers for all steps, and reads and writes each k-mer once.  The
results are bit-identical to the chain.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .. import limbs

BLOCK_LOG = 9  # k-mers per program
NUM_WARPS = 4


def _rotl1_cols(x, width: int):
    """`limbs.rotl1` over a list of limb columns (limb 0 most significant)."""
    L = len(x)
    msb_limb = L - 1 - (width - 1) // limbs.LIMB_BITS
    msb = (x[msb_limb] >> ((width - 1) % limbs.LIMB_BITS)) & 1
    mask = limbs.width_mask(width, L)
    out = []
    for l in range(L):
        col = x[l] << 1
        if l + 1 < L:
            col = col | (x[l + 1] >> (limbs.LIMB_BITS - 1))
        if mask[l] != 0xFFFFFFFF:
            col = col & int(mask[l])
        out.append(col)
    out[L - 1] = out[L - 1] | msb
    return out


@lru_cache(maxsize=None)
def _necklace_call(width: int, L: int, n: int, block_log: int,
                   interpret: bool):
    B = 1 << block_log

    def kernel(x_ref, best_ref, pos_ref):
        start = pl.program_id(0) * B
        ok = start + jnp.arange(B, dtype=jnp.int32) < n
        x = [plt.load(x_ref.at[pl.ds(start, B), l], mask=ok, other=0)
             for l in range(L)]

        def step(p, carry):
            rot, best, pos = carry
            rot = _rotl1_cols(rot, width)
            better = limbs.cols_lt(rot, best)
            best = [jnp.where(better, r, b) for r, b in zip(rot, best)]
            pos = jnp.where(better, p.astype(jnp.uint32), pos)
            return rot, best, pos

        _, best, pos = jax.lax.fori_loop(
            1, width, step, (x, x, jnp.zeros((B,), jnp.uint32)))
        for l in range(L):
            plt.store(best_ref.at[pl.ds(start, B), l], best[l], mask=ok)
        plt.store(pos_ref.at[pl.ds(start, B)], pos, mask=ok)

    return pl.pallas_call(
        kernel,
        grid=(-(-n // B),),
        out_shape=[jax.ShapeDtypeStruct((n, L), jnp.uint32),
                   jax.ShapeDtypeStruct((n,), jnp.uint32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name=f"necklace_w{width}",
    )


def necklace_pos_kernel(kmers, width: int, block_log: int = BLOCK_LOG,
                        interpret: bool = False):
    """[N, L] uint32 k-mer limbs of a `width`-bit value -> (necklace [N, L],
    pos [N] uint32), as `necklace.necklace_pos`."""
    n, L = kmers.shape
    if n == 0:
        return kmers, jnp.zeros((0,), jnp.uint32)
    best, pos = _necklace_call(width, L, n, block_log, interpret)(kmers)
    return best, pos
