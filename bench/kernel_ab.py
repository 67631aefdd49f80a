#!/usr/bin/env python
"""A/B measurements behind the hand-written GPU kernels (PERF.md, PR 1).

    python bench/kernel_ab.py [neck] [round] [sweep] [e2e]   # default: all

  neck   the XLA necklace chain at K=25 and K=59 on 2^25 rows: fusions in
         the compiled program, device kernels and time in a trace, the
         bytes bound at 3.35 TB/s; then the Pallas kernel against the chain.
  round  a trace of one dynamic round on the chip_smoke (c) log, and of
         the cummax liveness scan (`wordset.slog_counts`) alone.
  sweep  the merge kernel against `lax.sort(concat)`, balanced merges of
         2^12..2^23 rows at L = 2, 3, 4 (the floor MERGE_KERNEL_MIN_N).
  e2e    the 2^28-k-mer K=25 build and three dynamic rounds with each
         kernel switched off and on, in the order off, on, on, off.

On a CPU it runs tiny sizes with the kernels in interpret mode (a
rehearsal; its times mean nothing).  Traces go to chiprun_out/traces.
"""

from __future__ import annotations

import contextlib
import glob
import os
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402

CPU = jax.default_backend() == "cpu"
SZ = cs.REHEARSE if CPU else cs.FULL
TRACES = os.path.join(REPO, "chiprun_out", "traces")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak HBM3 bandwidth


def device_events(tag, fn):
    """Run fn once to warm up, then once under the profiler; returns the
    device kernels of the traced run as (ns, name, hlo_op)."""
    from jax.profiler import ProfileData

    jax.block_until_ready(fn())
    d = os.path.join(TRACES, tag)
    with jax.profiler.trace(d):
        jax.block_until_ready(fn())
    path = sorted(glob.glob(f"{d}/**/*.xplane.pb", recursive=True))[-1]
    evs = []
    for plane in ProfileData.from_file(path).planes:
        if ("CPU" if CPU else "GPU") not in plane.name:
            continue
        for line in plane.lines:
            if not CPU and "Stream" not in line.name:
                continue
            for ev in line.events:
                evs.append((float(ev.duration_ns), ev.name,
                            str(dict(ev.stats).get("hlo_op", ""))))
    print(f"[{tag}] {len(evs)} device events, "
          f"{sum(e[0] for e in evs) / 1e6:.4f} ms", flush=True)
    for ns, name, op in sorted(evs, reverse=True)[:8]:
        print(f"      {ns / 1e6:9.4f} ms {name[:70]} hlo_op={op[:50]}")
    return evs


def neck():
    from cbl_tpu import necklace
    from cbl_tpu.limbs import width_mask
    from cbl_tpu.ops.kernel_checks import necklace_kernel_check

    for width, L in ((50, 2), (118, 4)):
        n = 1 << (10 if CPU else 25)
        x = jax.random.bits(jax.random.PRNGKey(0), (n, L), jnp.uint32)
        x = x & jnp.asarray(width_mask(width, L))
        chain = jax.jit(lambda x: necklace.necklace_chain(x, width))
        hlo = chain.lower(x).compile().as_text()
        print(f"[neck] {width}-bit chain: {hlo.count('fusion(')} fusions "
              "in the compiled program", flush=True)
        device_events(f"neck_chain_w{width}", lambda: chain(x))
        bound = n * (2 * L + 1) * 4 / HBM_BYTES_PER_S
        r = necklace_kernel_check(width, L, n, reps=10, interpret=CPU)
        print(f"[neck] {width}-bit x {n}: ok={r['ok']} kernel "
              f"{r['kernel_ms']:.4f} ms, chain {r['chain_ms']:.4f} ms, "
              f"bytes bound {bound * 1e3:.4f} ms", flush=True)
        del x


def _round_index():
    from cbl_tpu import CBL

    k = 25
    base = cs.uniform_codes(SZ["log_kmers"] + k - 1, seed=3)
    idx = CBL(k=k, prefix_bits=24)
    idx.insert_codes_stream(base, np.array([0, len(base)], np.int64))
    streams = [tuple(idx.pack_stream(*s)
                     for s in cs._round_streams(SZ, r, base))
               for r in range(3)]
    return base, idx, streams


def round_():
    from cbl_tpu.wordset import slog_counts

    _, idx, streams = _round_index()
    for s in streams[:2]:
        jax.block_until_ready(idx.dynamic_round(*s, lazy=True))
    device_events("round", lambda: idx.dynamic_round(*streams[2], lazy=True))
    cols = idx.wordset._slog
    scan = jax.jit(lambda c: slog_counts(c, jnp.uint32(0xFF), True))
    device_events("slog_counts_alone", lambda: scan(cols))
    print(f"[round] log rows {cols[0].shape[0]}", flush=True)


def sweep():
    from cbl_tpu.ops.kernel_checks import merge_kernel_check

    for L in (2, 3, 4):
        for lg in range(12, 14 if CPU else 24):
            n = 1 << lg
            r = merge_kernel_check(L, n // 2, n // 2, reps=20, interpret=CPU)
            print(f"[sweep] L={L} n=2^{lg}: ok={r['ok']} kernel "
                  f"{r['kernel_ms']:.4f} ms lax.sort {r['lax_sort_ms']:.4f} ms",
                  flush=True)


def _routes():
    """(name, patches that switch the kernel off) for each kernel."""
    import cbl_tpu.necklace as nk
    import cbl_tpu.ops.merge as merge
    import cbl_tpu.wordset as ws

    no_merge = lambda n: False  # noqa: E731
    chain = lambda x, cfg: nk.necklace_chain(x, cfg.kmer_bits)  # noqa: E731
    return (("merge", [mock.patch.object(merge, "use_merge_kernel", no_merge),
                       mock.patch.object(ws, "use_merge_kernel", no_merge)]),
            ("necklace", [mock.patch.object(nk, "necklace_pos", chain)]))


def e2e():
    from cbl_tpu import CBL

    k = 25
    u = cs.uniform_codes(SZ["a_kmers"] + k - 1, seed=1)
    u_off = np.array([0, len(u)], np.int64)

    def run():
        idx = CBL(k=k, prefix_bits=24)
        ps = idx.pack_stream(u, u_off)
        jax.block_until_ready([s[1] for s in ps.slabs])
        t0 = time.perf_counter()
        idx.insert_codes_stream(ps)
        n = idx.count()
        t_build = time.perf_counter() - t0
        del idx, ps
        _, d, streams = _round_index()
        d.count()
        t0 = time.perf_counter()
        out = [d.dynamic_round(*s, lazy=True) for s in streams]
        res = [tuple(int(v) for v in jax.device_get(o)) for o in out]
        return (n, res), t_build, time.perf_counter() - t0

    for kernel, patches in _routes():
        answers = None
        for on in (False, True, True, False):
            with contextlib.ExitStack() as stack:
                for p in ([] if on else patches):
                    stack.enter_context(p)
                jax.clear_caches()  # re-trace under the chosen route
                t0 = time.perf_counter()
                warm = run()
                t_warm = time.perf_counter() - t0
                got = run()
            answers = answers or got[0]
            assert warm[0] == got[0] == answers, (answers, warm[0], got[0])
            print(f"[e2e] {kernel} kernel {'on' if on else 'off'}: build "
                  f"{SZ['a_kmers']} k-mers {got[1]:.4f} s, three rounds "
                  f"{got[2]:.4f} s; warm-up incl. compile {t_warm:.2f} s",
                  flush=True)
    jax.clear_caches()


def main(argv):
    steps = {"neck": neck, "round": round_, "sweep": sweep, "e2e": e2e}
    print("\n".join(cs.card_lines()), flush=True)
    for name in argv or list(steps):
        steps[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
