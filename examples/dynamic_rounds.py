#!/usr/bin/env python
"""Interleaved insert/query/remove rounds over the sorted-log
representation.

The reference supports fully dynamic per-op updates
(`/root/reference/src/wordset/mod.rs:97-137`); the batched shape of
that workload is `CBL.dynamic_round`: each round is ONE device program
(sort the round's own batch, one merge pass into a persistently
sorted log, one hit scan), all rounds pipeline asynchronously, and the
scalars sync once at the end.  `count()` scans the log without folding.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from cbl_tpu import CBL

    k = 25
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    seg_bases = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=rounds * seg_bases, dtype=np.uint8)
    off = np.array([0, seg_bases], dtype=np.int64)
    off_h = np.array([0, seg_bases // 2], dtype=np.int64)

    idx = CBL(k=k)
    segs = [
        idx.pack_stream(codes[i * seg_bases : (i + 1) * seg_bases], off)
        for i in range(rounds)
    ]
    halves = [
        idx.pack_stream(
            codes[i * seg_bases : i * seg_bases + seg_bases // 2], off_h
        )
        for i in range(rounds)
    ]
    jax.block_until_ready([s[1] for ps in segs for s in ps.slabs])

    t0 = time.time()
    pos_dev = None
    ops = 0
    for i in range(rounds):
        # insert segment i; query the previous segment (sees the inserts,
        # not this round's removes); remove the first half of segment i
        total, p = idx.dynamic_round(
            segs[i], segs[i - 1 if i else 0], halves[i], lazy=True
        )
        pos_dev = p if pos_dev is None else pos_dev + p
        ops += 2 * (seg_bases - k + 1) + seg_bases // 2 - k + 1
    n, positive = (
        int(x) for x in jax.device_get((idx.count_device(), pos_dev))
    )
    dt = time.time() - t0
    print(
        f"{rounds} rounds / {ops} k-mer ops in {dt:.3f}s "
        f"({ops/dt/1e6:.1f}M ops/s): {n} distinct k-mers live, "
        f"{positive} positive queries"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
