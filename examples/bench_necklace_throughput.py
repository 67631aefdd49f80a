#!/usr/bin/env python
"""Necklace kernel microbenchmark: ns per necklace.

Counterpart of `/root/reference/examples/bench_necklace_throughput.rs:17-35`
(N random words, M=9, prints time per necklace) — here the batched
vectorized kernel instead of the streaming queue."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    import jax

    from cbl_tpu import necklace
    from cbl_tpu.config import get_config

    cfg = get_config(k=k, prefix_bits=24)
    rng = np.random.default_rng(42)
    L = cfg.kmer_limbs
    arr = rng.integers(0, 1 << 32, size=(n, L), dtype=np.uint64).astype(np.uint32)
    # mask to kmer_bits
    from cbl_tpu.limbs import width_mask

    arr &= width_mask(cfg.kmer_bits, L)

    fn = jax.jit(lambda x: necklace.necklace_pos(x, cfg))
    dev = jax.device_put(arr)
    jax.block_until_ready(fn(dev))  # compile + warmup
    t0 = time.time()
    jax.block_until_ready(fn(dev))
    dt = time.time() - t0
    print(f"{n} necklaces (K={k}, {cfg.kmer_bits} bits) in {dt:.4f}s "
          f"= {dt / n * 1e9:.3f} ns/necklace = {n / dt / 1e6:.1f}M/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
