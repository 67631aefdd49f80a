"""Multi-host (multi-process) scaffolding.

A multi-host cluster runs one process per host; `jax.distributed.initialize`
joins them into one global device mesh, after which ShardedCBL works
unchanged (its mesh spans all global devices and `all_to_all`/`psum` ride
ICI).  The host-side seam is input partitioning: each host parses and streams
a disjoint slice of the input records (DP read streaming, SURVEY.md §2.9) —
set semantics make insert order irrelevant, so no cross-host coordination is
needed beyond the collectives in the update step.

This sandbox has a single host, so multi-process bring-up is exercised only
as far as the helpers below; the device-level collectives are validated on
the 8-device CPU mesh (tests/test_sharding.py) and via dryrun_multichip.
"""

from __future__ import annotations

import numpy as np


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join a multi-process JAX cluster (no-op if single-process).

    Pass the arguments explicitly: nothing detects the cluster
    (coordinator_address such as "localhost:<port>")."""
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def multihost_insert_stream(idx, codes: np.ndarray, offsets: np.ndarray,
                            nk_sub: int = 4096, icap: int = 64) -> None:
    """Insert THIS process's record slice into a global ShardedCBL.

    Every process calls this with its own (codes, offsets) sub-stream
    (`host_record_slice` + `slice_codes`); each builds uniform fused
    sub-slab groups for its LOCAL devices, assembles them into global
    arrays with `make_array_from_process_local_data`, and all processes
    run the same bulk insert step (pipeline -> all-to-all -> merge).
    Shapes are coordinated: fixed nk_sub/icap, group count = max over
    processes (short processes contribute all-blank dummy slabs).

    Reference seam being generalized: the k-way merge of independently
    built indexes, `/root/reference/src/wordset/set_ops.rs:11-76`."""
    import jax
    from jax.experimental import multihost_utils as mh

    from .shard import build_slab_groups

    n_proc = jax.process_count()
    d_local = idx.D // n_proc
    front = idx._front()
    # agree on DATA-DRIVEN boundaries: uncoordinated per-process quantile
    # init would diverge (each process sees only its slice), but keeping
    # the uniform top-bit defaults is worse — necklace words are so
    # skewed that one shard takes ~98% of the load and later routing
    # buckets (insert and dynamic-round alike) overflow.  Process 0
    # derives quantiles from ITS first slab; everyone adopts them.
    if not idx._boundaries_from_data and n_proc > 1 and idx.D > 1:
        _agree_boundaries_from_stream(idx, codes, offsets, nk_sub)
    # agree on the number of groups
    nk = max(len(codes) - idx.cfg.k + 1, 0)
    n_local = (max(nk, 1) + nk_sub - 1) // nk_sub
    n_groups_local = (n_local + d_local - 1) // d_local
    n_groups = int(np.max(mh.process_allgather(np.array([n_groups_local]))))
    for nk_sub_, stream, starts, ends in build_slab_groups(
        front, codes, offsets, nk_sub, d_local, icap=icap, n_groups=n_groups
    ):
        idx._insert_group(
            nk_sub_,
            idx._put_rows(stream),
            idx._put_rows(starts),
            idx._put_rows(ends),
        )
    idx._check_dropped()


def multihost_remove_stream(idx, codes: np.ndarray, offsets: np.ndarray,
                            nk_sub: int = 4096, icap: int = 64) -> None:
    """Remove THIS process's record slice from a global ShardedCBL — the
    bulk remove analog of `multihost_insert_stream` (reference contract:
    remove_batch, `/root/reference/src/wordset/mod.rs:218-237`)."""
    import jax
    from jax.experimental import multihost_utils as mh

    from .shard import build_slab_groups

    n_proc = jax.process_count()
    d_local = idx.D // n_proc
    front = idx._front()
    nk = max(len(codes) - idx.cfg.k + 1, 0)
    n_local = (max(nk, 1) + nk_sub - 1) // nk_sub
    n_groups_local = (n_local + d_local - 1) // d_local
    n_groups = int(np.max(mh.process_allgather(np.array([n_groups_local]))))
    for nk_sub_, stream, starts, ends in build_slab_groups(
        front, codes, offsets, nk_sub, d_local, icap=icap, n_groups=n_groups
    ):
        idx._remove_group(
            nk_sub_,
            idx._put_rows(stream),
            idx._put_rows(starts),
            idx._put_rows(ends),
        )


def multihost_query_stream(idx, codes: np.ndarray, offsets: np.ndarray,
                           nk_sub: int = 4096, icap: int = 64):
    """(total, positive) over the UNION of all processes' record slices."""
    import jax
    from jax.experimental import multihost_utils as mh

    from .shard import build_slab_groups

    n_proc = jax.process_count()
    d_local = idx.D // n_proc
    front = idx._front()
    nk = max(len(codes) - idx.cfg.k + 1, 0)
    n_local = (max(nk, 1) + nk_sub - 1) // nk_sub
    n_groups_local = (n_local + d_local - 1) // d_local
    n_groups = int(np.max(mh.process_allgather(np.array([n_groups_local]))))
    total_dev = positive_dev = None
    for nk_sub_, stream, starts, ends in build_slab_groups(
        front, codes, offsets, nk_sub, d_local, icap=icap, n_groups=n_groups
    ):
        t, p = idx._query_group(
            nk_sub_,
            idx._put_rows(stream),
            idx._put_rows(starts),
            idx._put_rows(ends),
        )
        total_dev = t if total_dev is None else total_dev + t
        positive_dev = p if positive_dev is None else positive_dev + p
    if total_dev is None:
        return 0, 0
    return idx._reduce_query(total_dev, positive_dev)


def _agree_boundaries_from_stream(idx, codes: np.ndarray,
                                  offsets: np.ndarray, nk_sub: int = 4096,
                                  icap: int = 64) -> None:
    """Adopt process 0's data-quantile range boundaries on every process
    (one broadcast).  Every process derives quantiles from its own first
    sub-slab (cheap, one pipeline pass), then overwrites them with the
    broadcast so the SPMD programs see identical values."""
    from jax.experimental import multihost_utils as mh

    from .shard import build_slab_groups

    icap = max(icap, 1 << max(4, int(len(offsets) + 2).bit_length()))
    g = next(iter(build_slab_groups(
        idx._front(), codes, offsets, nk_sub, 1, icap=icap, n_groups=1
    )))
    idx._maybe_init_boundaries_from_stream(*g)
    idx.boundaries = np.asarray(
        mh.broadcast_one_to_all(np.asarray(idx.boundaries))
    ).astype(np.uint32)
    idx._boundaries_from_data = True


def multihost_pack_stream(idx, codes: np.ndarray, offsets: np.ndarray,
                          nk_sub: int = 4096, icap: int = 64):
    """Stage THIS process's record slice as a SINGLE-group ShardedStream
    on the global mesh — the multi-process analog of
    `ShardedCBL.pack_stream` for dynamic rounds.

    Shapes must be identical on every process (one SPMD program): nk_sub
    is raised until the local slice fits its d_local sub-slabs, then
    allgather-maxed so all processes stage the same slab geometry; short
    processes contribute all-blank dummy slabs."""
    import jax
    from jax.experimental import multihost_utils as mh

    from .shard import ShardedStream, build_slab_groups

    n_proc = jax.process_count()
    d_local = idx.D // n_proc
    front = idx._front()
    k = idx.cfg.k
    # slabs cover the WHOLE code stream contiguously (records are handled
    # by blank intervals, `CBL._fused_slabs`), so the slab count is
    # ceil(nk / nk_sub): grow nk_sub until the local slice fits one group
    nk = max(len(codes) - k + 1, 0)
    while -(-max(nk, 1) // nk_sub) > d_local:
        nk_sub *= 2
    # a slab's blank-interval count grows with the records it covers;
    # coordinate a cap that fits every process's record density
    icap = max(icap, 1 << max(4, int(len(offsets) + 2).bit_length()))
    agreed = mh.process_allgather(np.array([nk_sub, icap]))
    nk_sub = int(np.max(agreed[..., 0]))
    icap = int(np.max(agreed[..., 1]))
    (nk_sub_, stream, starts, ends), = build_slab_groups(
        front, codes, offsets, nk_sub, d_local, icap=icap, n_groups=1
    )
    ss = ShardedStream(
        (idx.cfg, idx.canonical, id(idx.mesh)),
        [(nk_sub_, idx._put_rows(stream), idx._put_rows(starts),
          idx._put_rows(ends))],
    )
    ss._host0 = (nk_sub_, stream, starts, ends)
    return ss


def multihost_dynamic_round(idx, ins, qry, rm, lazy: bool = False):
    """One interleaved insert/count-query/remove round over the GLOBAL
    mesh from per-process record slices — the multi-host analog of
    `ShardedCBL.dynamic_round` (reference per-op contract:
    `/root/reference/src/wordset/mod.rs:97-137`).

    Each arg is THIS process's (codes, offsets) slice or a staged stream
    from `multihost_pack_stream` (re-used streams keep their sorted-words
    memo across rounds).  Boundaries are agreed before the first round
    (process 0 derives data quantiles, everyone adopts them), after which
    the round is one SPMD program; the scalar results replicate via psum
    so each process reads them from its local shard."""
    import jax
    from jax.experimental import multihost_utils as mh

    from .shard import ShardedStream

    ps = [
        x if isinstance(x, ShardedStream) else multihost_pack_stream(idx, *x)
        for x in (ins, qry, rm)
    ]
    if (jax.process_count() > 1 and idx.D > 1
            and not idx._boundaries_from_data
            and idx._slog_dev is None and idx._count_upper == 0):
        # data-driven boundary init diverges per process (each sees only
        # its slice); derive locally, then adopt process 0's values
        idx._maybe_init_boundaries_from_stream(*ps[0]._host0)
        idx.boundaries = np.asarray(
            mh.broadcast_one_to_all(np.asarray(idx.boundaries))
        ).astype(np.uint32)
        idx._boundaries_from_data = True
    nv_q, hits = idx.dynamic_round(*ps, lazy=True)
    if lazy:
        return nv_q, hits
    return idx._reduce_query(nv_q, hits)


def _assert_local_shards_match(idx, ref_words: np.ndarray, ctx: str) -> None:
    """Word-level placement check: this process's shard slices must equal
    the corresponding count-delimited slices of the single-device sorted
    word array (shard-major == global sorted order) — a routing bug that
    misplaces words while preserving the global count fails here."""
    counts = idx.shard_counts
    assert int(counts.sum()) == ref_words.shape[0], (
        ctx, int(counts.sum()), ref_words.shape[0])
    starts = np.concatenate([[0], np.cumsum(counts)])
    for gid, rows in idx.local_shard_rows().items():
        expect = ref_words[starts[gid] : starts[gid + 1]]
        np.testing.assert_array_equal(rows, expect, err_msg=f"{ctx} shard {gid}")


def run_multihost_dryrun_worker(coordinator: str, n_proc: int, pid: int,
                                bases: int = 60_000, k: int = 25) -> None:
    """Worker body for the 2-process CPU validation (BASELINE config 5's
    testable half): initialize the process group, build ONE global
    ShardedCBL from per-process record slices, then verify against a
    single-device build of the full stream at WORD level (exact shard
    placement), through a remove round, a set-algebra op, and a sharded
    checkpoint round-trip."""
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator, num_processes=n_proc, process_id=pid
    )
    assert jax.process_count() == n_proc
    from ..cbl import CBL
    from .shard import ShardedCBL, make_mesh

    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=bases, dtype=np.uint8)
    offsets = np.array(
        [0, bases // 3, bases // 2, bases - 11, bases], dtype=np.int64
    )
    lo, hi = host_record_slice(offsets, pid, n_proc)
    codes_l, offsets_l = slice_codes(codes, offsets, lo, hi)

    mesh = make_mesh()  # all global devices
    idx = ShardedCBL(k=k, mesh=mesh)
    multihost_insert_stream(idx, codes_l, offsets_l)
    n = idx.count()

    # expected set from a single-device build of the FULL stream
    ref = CBL(k=k)
    ref.insert_codes_stream(codes, offsets)
    expect = ref.count()
    assert n == expect, f"multihost count {n} != single-device {expect}"
    _assert_local_shards_match(idx, ref.wordset.words_array(), "build")

    total, positive = multihost_query_stream(idx, codes_l, offsets_l)
    nk_expect = sum(
        max(int(offsets[i + 1] - offsets[i]) - k + 1, 0)
        for i in range(len(offsets) - 1)
    )
    assert total == nk_expect, (total, nk_expect)
    assert positive == total, (positive, total)

    # sharded checkpoint round-trip: one npz per process, no global gather
    ck = f"/tmp/cbl_mh_ck_{coordinator.rsplit(':', 1)[-1]}.npz"
    idx.save_to_file(ck)
    back = ShardedCBL.load_from_file(ck, mesh=mesh)
    assert back.count() == n
    _assert_local_shards_match(back, ref.wordset.words_array(), "checkpoint")

    # remove round: every process removes the FIRST record of its slice
    rm_off = offsets_l[:2].copy()
    rm_codes = codes_l[: rm_off[1]]
    multihost_remove_stream(idx, rm_codes, rm_off)
    for p in range(n_proc):
        plo, phi = host_record_slice(offsets, p, n_proc)
        sub, sub_off = slice_codes(codes, offsets, plo, phi)
        ref.remove_codes_stream(sub[: sub_off[1]], sub_off[:2])
    assert idx.count() == ref.count(), (idx.count(), ref.count())
    _assert_local_shards_match(idx, ref.wordset.words_array(), "remove")
    t2, p2 = multihost_query_stream(idx, codes_l, offsets_l)
    assert t2 == nk_expect and 0 < p2 < t2, (t2, p2)

    # set algebra across the mesh: intersect with the checkpoint copy
    # (= pre-remove set), expect exactly the post-remove set back
    inter = idx & back
    assert inter.count() == idx.count()
    _assert_local_shards_match(inter, ref.wordset.words_array(), "intersect")

    # interleaved dynamic rounds across processes (round-4 verdict item
    # 4): per round every process contributes ITS slice of the three
    # streams; (total, positive) and the folded word placement must match
    # the single-device rounds on the full streams exactly
    rng2 = np.random.default_rng(11)
    segs = []
    for _ in range(3):
        scodes = rng2.integers(0, 4, size=4000, dtype=np.uint8)
        soff = np.arange(0, 4001, 1000, dtype=np.int64)  # 4 records
        segs.append((scodes, soff))

    def proc_slice(seg):
        lo_, hi_ = host_record_slice(seg[1], pid, n_proc)
        return slice_codes(seg[0], seg[1], lo_, hi_)

    staged = [multihost_pack_stream(idx, *proc_slice(s)) for s in segs]
    halves = []
    for scodes, soff in segs:
        hoff = soff[: len(soff) // 2 + 1].copy()
        halves.append((scodes[: hoff[-1]], hoff))
    staged_h = [multihost_pack_stream(idx, *proc_slice(h)) for h in halves]
    for r in range(3):
        t_mh, p_mh = multihost_dynamic_round(
            idx, staged[r], staged[r - 1 if r else 0], staged_h[r]
        )
        t_ref, p_ref = ref.dynamic_round(
            segs[r], segs[r - 1 if r else 0], halves[r]
        )
        assert (t_mh, p_mh) == (t_ref, p_ref), (r, t_mh, p_mh, t_ref, p_ref)
    assert idx.count() == ref.count(), (idx.count(), ref.count())
    idx._fold_slog()  # placement check reads the folded data slices
    assert idx.count() == ref.count(), (idx.count(), ref.count())
    _assert_local_shards_match(idx, ref.wordset.words_array(), "dyn-rounds")

    # post-round sharded checkpoint: save folds the log; reload matches
    ck2 = f"/tmp/cbl_mh_ck2_{coordinator.rsplit(':', 1)[-1]}.npz"
    idx.save_to_file(ck2)
    back2 = ShardedCBL.load_from_file(ck2, mesh=mesh)
    assert back2.count() == ref.count()
    _assert_local_shards_match(
        back2, ref.wordset.words_array(), "dyn-checkpoint"
    )
    if pid == 0:
        import os

        for base_ in (ck, ck2):
            for f in (base_, ShardedCBL._shard_file(base_, 0, n_proc),
                      ShardedCBL._shard_file(base_, 1, n_proc)):
                if os.path.exists(f):
                    os.remove(f)
        print(f"MULTIHOST_OK n={n} total={total} after_remove={idx.count()}",
              flush=True)


def launch_multihost_dryrun(n_proc: int = 2, devices_per_proc: int = 4,
                            bases: int = 60_000, timeout: int = 600) -> None:
    """Spawn n_proc local processes (each with its own CPU device set) and
    run `run_multihost_dryrun_worker` in every one."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = []
    for pid in range(n_proc):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={devices_per_proc}"
        )
        code = (
            "from cbl_tpu.parallel.distributed import "
            "run_multihost_dryrun_worker as w; "
            f"w({coordinator!r}, {n_proc}, {pid}, bases={bases})"
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=repo, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout)
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(
                f"multihost worker {pid} failed (rc {p.returncode}):\n{out[-3000:]}"
            )
    assert "MULTIHOST_OK" in outs[0], outs[0][-3000:]


def host_record_slice(offsets: np.ndarray, host_id: int, n_hosts: int):
    """Assign records to this host, balanced by total bases.

    offsets: [n_records+1] record boundaries of a code stream.  Returns
    (record_lo, record_hi): this host's contiguous record range.  Contiguous
    ranges keep each host's stream a single slice of the input file."""
    total = int(offsets[-1])
    lo_target = total * host_id // n_hosts
    hi_target = total * (host_id + 1) // n_hosts
    record_lo = int(np.searchsorted(offsets[:-1], lo_target, side="left"))
    record_hi = int(np.searchsorted(offsets[:-1], hi_target, side="left"))
    if host_id == n_hosts - 1:
        record_hi = len(offsets) - 1
    return record_lo, record_hi


def slice_codes(codes: np.ndarray, offsets: np.ndarray, record_lo: int,
                record_hi: int):
    """Extract one host's (codes, offsets) sub-stream."""
    lo = int(offsets[record_lo])
    hi = int(offsets[record_hi])
    sub = codes[lo:hi]
    sub_off = offsets[record_lo : record_hi + 1] - lo
    return sub, sub_off.astype(np.int64)
