#!/usr/bin/env python
"""Partition re-balancing and lossless overflow recovery walkthrough.

The sharded index range-partitions the necklace word space by data
quantiles frozen at first insert.  When later data skews the load, two
mechanisms keep the index healthy (reference seam: the repartition
statistics exist precisely so the partition can be re-tuned,
`/root/reference/src/wordset/mod.rs:254-295`,
`/root/reference/examples/cbl.rs:310-366`):

1. `ShardedCBL.repartition()` — recompute exact global-quantile
   boundaries from the sorted shard slices and re-route every word with
   ONE all_to_all (a destination receives exactly its rank range, so the
   re-route cannot drop rows).
2. Insert streams auto-recover from routing-bucket overflow: inserts
   are idempotent, so the stream repartitions and re-runs itself with
   doubled bucket capacity instead of corrupting the index.

Run on 8 virtual CPU devices:

    env JAX_PLATFORMS=cpu \
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/repartition_recovery.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from cbl_tpu.parallel import ShardedCBL

    rng = np.random.default_rng(0)
    idx = ShardedCBL(k=25)
    print(f"mesh: {idx.D} device(s)")

    # 1) normal build: boundaries come from the first batch's quantiles
    codes = rng.integers(0, 4, size=200_000, dtype=np.uint8)
    idx.insert_codes_stream(codes, np.array([0, len(codes)], dtype=np.int64))
    print(f"built {idx.count()} k-mers; balance {idx.shard_balance().tolist()}")

    # 2) skewed growth: tiny-valued words all land on shard 0
    skew = np.zeros((100_000, idx.L), dtype=np.uint32)
    skew[:, idx.L - 1] = np.arange(100_000, dtype=np.uint32)
    idx.insert_words(skew)
    print(f"after skewed growth: balance {idx.shard_balance().tolist()}")

    # 3) one re-balance restores the quantile partition
    t0 = time.time()
    idx.repartition()
    print(f"repartitioned in {time.time()-t0:.2f}s; "
          f"balance {idx.shard_balance().tolist()}")

    # 4) pathological boundaries + a big stream: the insert recovers on
    #    its own (repartition + idempotent re-run), zero lost words
    bad = ShardedCBL(k=25)
    bad.boundaries = np.full_like(np.asarray(bad.boundaries), 0xFFFFFFFF)
    bad._boundaries_from_data = True  # freeze the bad partition
    bad.insert_codes_stream(codes, np.array([0, len(codes)], dtype=np.int64))
    print(f"overflow recovery: {bad.count()} k-mers "
          f"(= {idx.count() - 100_000} expected), "
          f"balance {bad.shard_balance().tolist()}")


if __name__ == "__main__":
    main()
