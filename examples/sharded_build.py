#!/usr/bin/env python
"""Multi-device sharded build + query + checkpoint walkthrough.

Counterpart of `/root/reference/examples/build_from_fastx.rs` scaled to a
device mesh: the necklace word space is range-partitioned over all local
devices, k-mers are routed to owner shards with one all-to-all per slab
group, and set counts reduce with psum.  Runs on any device count —
including 8 virtual CPU devices:

    env JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_build.py reads.fa
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from cbl_tpu.io import parse_fastx
    from cbl_tpu.parallel import ShardedCBL

    if len(sys.argv) > 1:
        codes, offsets = parse_fastx(sys.argv[1])
    else:  # no input file: synthesize reads
        rng = np.random.default_rng(0)
        codes = rng.integers(0, 4, size=2_000_000, dtype=np.uint8)
        offsets = np.arange(0, len(codes) + 1, 10_000, dtype=np.int64)

    idx = ShardedCBL(k=25, canonical=True)
    print(f"devices: {idx.D}", file=sys.stderr)
    t0 = time.time()
    idx.insert_codes_stream(codes, offsets)
    n = idx.count()
    print(f"built {n} distinct 25-mers in {time.time()-t0:.2f}s; "
          f"shard balance {idx.shard_balance().tolist()}", file=sys.stderr)

    total, positive = idx.query_codes_stream(codes, offsets)
    print(f"self-query: {positive}/{total} positive", file=sys.stderr)

    masks = idx.contains_seqs([codes[:1000], codes[5000:5600]])
    print(f"ordered masks: {[int(m.sum()) for m in masks]} hits",
          file=sys.stderr)

    idx.save_to_file("/tmp/sharded_example.npz")
    back = ShardedCBL.load_from_file("/tmp/sharded_example.npz")
    assert back.count() == n
    print("checkpoint round-trip OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
