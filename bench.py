#!/usr/bin/env python
"""cbl_tpu benchmark — prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "kmers/s", "vs_baseline": N, ...}

The default run measures the static headline (the metric/value/unit/
vs_baseline fields the driver parses) PLUS same-session extra keys so
every north-star number is driver-verifiable from one line:
canonical_kmers_per_s, dynamic_ops_per_s + dynamic_vs_local,
sharded_dynamic_ops_per_s + sharded_dynamic_ratio, genome_kmers_per_s +
genome_vs_baseline, algebra_ms + serde_s.  All counts are cross-checked
against bench/baseline.cpp in the same session (--headline-only skips
the extras; --mode <name> still runs one workload alone).

Metric (BASELINE.md north star): insert_seq + contains_seq k-mers/sec/chip at
K=25 on synthetic E. coli-scale data.  vs_baseline compares against a
single-CPU-core reference-class implementation (bench/baseline.cpp: the CBL
paper's streaming-necklace algorithm + a flat hash set, measured on this
machine — a *stronger* CPU baseline than the reference's rank/trie structures,
so the ratio is conservative).

The reference repo publishes no numbers (BASELINE.md) and cannot be built
here (no Rust toolchain, vendored submodules absent), so the baseline is
measured, not quoted.

Both implementations process the same 2-bit code stream and must agree on
the distinct-k-mer count (cross-validation, not just timing).
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np


def build_baseline(build_dir: str = os.path.join(REPO, "bench",
                                                 "build")) -> str:
    """Compile bench/baseline.cpp into `build_dir` (keyed by the source's
    content hash, so an edited source is always rebuilt); returns the
    executable's path."""
    from cbl_tpu.io import build_from_source

    return build_from_source(os.path.join(REPO, "bench", "baseline.cpp"),
                             build_dir, "baseline")


def _run_baseline_cmd(arrays, args, timeout: int) -> dict:
    """Run the baseline on `arrays` (each written to a temporary file) with
    `args` after the file paths' slots, and parse its JSON line."""
    import tempfile

    exe = build_baseline()
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for i, arr in enumerate(arrays):
            p = os.path.join(td, f"in{i}.bin")
            arr.tofile(p)
            paths.append(p)
        out = subprocess.run(
            [exe] + args(paths), capture_output=True, check=True,
            timeout=timeout,
        ).stdout
    return json.loads(out)


def run_baseline(codes: np.ndarray, canonical: bool = False) -> dict:
    return _run_baseline_cmd(
        [codes], lambda p: p + (["canonical"] if canonical else []), 600
    )


def run_device(codes: np.ndarray, chunk: int, pending_cap: int,
               repeats: int = 2, canonical: bool = False):
    from cbl_tpu import CBL

    offsets = np.array([0, len(codes)], dtype=np.int64)
    best = None
    for r_i in range(repeats):  # first repeat absorbs compiles; keep the best
        idx = CBL(k=25, chunk_size=chunk, pending_cap=pending_cap,
                  canonical=canonical)
        # Stage the input in device memory BEFORE the timers, mirroring the
        # baseline's accounting (baseline.cpp freads the codes into RAM
        # before ITS timers): both sides start with the input resident in
        # their compute memory.  Staging cost is reported separately.
        t_s = time.time()
        ps = idx.pack_stream(codes, offsets)
        import jax

        jax.block_until_ready([s[1] for s in ps.slabs])
        stage_s = time.time() - t_s
        # Single-sync protocol: enqueue insert, count, query, then ONE
        # scalar device_get.  The phase split at t1 is dispatch-enqueue time
        # only (device work overlaps the query enqueue); the metric uses
        # the combined t2-t0 wall which ends at a real sync.
        t0 = time.time()
        idx.insert_codes_stream(ps)
        n_dev = idx.count_device()
        t1 = time.time()
        total_dev, pos_dev = idx.query_codes_stream(ps, lazy=True)
        n_distinct, total, positive = (
            int(x) for x in jax.device_get((n_dev, total_dev, pos_dev))
        )
        t2 = time.time()
        r = {
            "distinct": n_distinct,
            "total": total,
            "positive": positive,
            "insert_s": t1 - t0,
            "query_s": t2 - t1,
        }
        print(f"  repeat {r_i}: stage {stage_s:.3f}s "
              f"combined {t2 - t0:.3f}s (enqueue split "
              f"{r['insert_s']:.3f}/{r['query_s']:.3f})", file=sys.stderr)
        if best is None or (r["insert_s"] + r["query_s"]) < (
            best["insert_s"] + best["query_s"]
        ):
            best = r
    return best


def make_genome_corpus(bases: int, seed: int = 0, read_len: int = 10240,
                       qread_len: int = 2048):
    """Repeat-rich synthetic corpus with a ~50% query hit rate (BASELINE
    config 1's "E. coli reads" stand-in; the reference repo ships no data,
    `/root/reference/examples/cbl.rs:143-167` is the record-stream loop the
    shapes mirror).

    - genome: mutated copies (0.5% point mutations) from a 12-unit repeat
      pool, joined by short unique linkers -> heavy k-mer duplication and
      a skewed prefix/bucket distribution (unlike uniform-random bases);
    - insert stream: the genome cut into `read_len`-base records;
    - query stream: alternating windows sampled inside single insert
      records (all k-mers present) and uniform-random records (~0 hits).

    Returns (codes_i, off_i, codes_q, off_q).
    """
    rng = np.random.default_rng(seed)
    units = [
        rng.integers(0, 4, size=int(n), dtype=np.uint8)
        for n in rng.integers(300, 4000, size=12)
    ]
    parts, total = [], 0
    while total < bases:
        u = units[int(rng.integers(0, len(units)))].copy()
        mut = rng.random(len(u)) < 0.005
        u[mut] = (u[mut] + rng.integers(1, 4, size=int(mut.sum()))
                  .astype(np.uint8)) % 4
        linker = rng.integers(
            0, 4, size=int(rng.integers(20, 200)), dtype=np.uint8
        )
        parts += [u, linker]
        total += len(u) + len(linker)
    genome = np.concatenate(parts)[:bases]
    off_i = np.append(
        np.arange(0, bases, read_len, dtype=np.int64), np.int64(bases)
    )
    n_q = bases // qread_len
    q_parts = []
    for i in range(n_q):
        if i % 2 == 0:  # hit window inside ONE insert record
            rec = int(rng.integers(0, len(off_i) - 1))
            lo, hi = int(off_i[rec]), int(off_i[rec + 1])
            if hi - lo < qread_len:
                rec = 0
                lo, hi = 0, int(off_i[1])
            start = int(rng.integers(lo, hi - qread_len + 1))
            q_parts.append(genome[start : start + qread_len])
        else:  # random record: ~0 hits in a 2^50 word space
            q_parts.append(rng.integers(0, 4, size=qread_len, dtype=np.uint8))
    codes_q = np.concatenate(q_parts)
    off_q = np.arange(0, len(codes_q) + 1, qread_len, dtype=np.int64)
    return genome, off_i, codes_q, off_q


def run_baseline_records(codes_i, off_i, codes_q, off_q,
                         canonical: bool = False) -> dict:
    return _run_baseline_cmd(
        [codes_i, off_i, codes_q, off_q],
        lambda p: [p[0], "records", p[1], p[2], p[3]]
        + (["canonical"] if canonical else []),
        1200,
    )


def run_device_records(codes_i, off_i, codes_q, off_q, chunk: int,
                       pending_cap: int, repeats: int,
                       canonical: bool = False):
    from cbl_tpu import CBL

    best = None
    for r_i in range(repeats):
        idx = CBL(k=25, chunk_size=chunk, pending_cap=pending_cap,
                  canonical=canonical)
        t_s = time.time()
        psi = idx.pack_stream(codes_i, off_i)
        psq = idx.pack_stream(codes_q, off_q)
        import jax

        jax.block_until_ready(
            [s[1] for s in psi.slabs] + [s[1] for s in psq.slabs]
        )
        stage_s = time.time() - t_s
        # single-sync protocol (see run_device)
        t0 = time.time()
        idx.insert_codes_stream(psi)
        n_dev = idx.count_device()
        t1 = time.time()
        total_dev, pos_dev = idx.query_codes_stream(psq, lazy=True)
        n_distinct, total, positive = (
            int(x) for x in jax.device_get((n_dev, total_dev, pos_dev))
        )
        t2 = time.time()
        r = {
            "distinct": n_distinct,
            "total": total,
            "positive": positive,
            "insert_s": t1 - t0,
            "query_s": t2 - t1,
        }
        print(f"  genome repeat {r_i}: stage {stage_s:.3f}s "
              f"combined {t2 - t0:.3f}s (enqueue split "
              f"{r['insert_s']:.3f}/{r['query_s']:.3f}) "
              f"hit-rate {positive/max(total,1):.3f}", file=sys.stderr)
        if best is None or (r["insert_s"] + r["query_s"]) < (
            best["insert_s"] + best["query_s"]
        ):
            best = r
    return best


def collect_genome(args, canonical: bool = False) -> dict:
    codes_i, off_i, codes_q, off_q = make_genome_corpus(args.bases)
    nk_i = sum(
        max(int(off_i[i + 1] - off_i[i]) - 24, 0)
        for i in range(len(off_i) - 1)
    )
    nk_q = sum(
        max(int(off_q[i + 1] - off_q[i]) - 24, 0)
        for i in range(len(off_q) - 1)
    )
    base = None
    if not args.skip_baseline:
        base = run_baseline_records(codes_i, off_i, codes_q, off_q,
                                    canonical=canonical)
        print(f"baseline genome (1 CPU core): {base}", file=sys.stderr)
    ours = run_device_records(
        codes_i, off_i, codes_q, off_q, args.chunk, args.pending_cap,
        args.repeats, canonical=canonical,
    )
    print(f"cbl_tpu genome: {ours}", file=sys.stderr)
    assert ours["total"] == nk_q, (ours["total"], nk_q)
    assert 0 < ours["positive"] < ours["total"], ours  # real misses
    if base is not None:
        assert ours["distinct"] == base["distinct"], (ours, base)
        assert ours["positive"] == base["positive"], (ours, base)
        base_comb = (nk_i + nk_q) / (base["insert_s"] + base["query_s"])
        vs = ((nk_i + nk_q) / (ours["insert_s"] + ours["query_s"])) / base_comb
    else:
        vs = None
    return {
        "kmers_per_s": (nk_i + nk_q) / (ours["insert_s"] + ours["query_s"]),
        "vs_baseline": vs,
    }


def mode_genome(args):
    g = collect_genome(args, canonical=args.canonical)
    canon = ", canonical" if args.canonical else ""
    print(json.dumps({
        "metric": "insert_seq+contains_seq k-mers/s per chip (K=25"
        f"{canon}, {args.bases/1e6:.0f}Mbp repeat-rich genome records, "
        "~50% query hit rate)",
        "value": round(g["kmers_per_s"], 1),
        "unit": "kmers/s",
        "vs_baseline": round(g["vs_baseline"], 3) if g["vs_baseline"] else None,
    }))


SEGS = 8  # dynamic-mode segments (must match bench/baseline.cpp run_dynamic)


def run_baseline_dynamic(codes: np.ndarray) -> dict:
    return _run_baseline_cmd([codes], lambda p: p + ["dynamic"], 600)


def run_device_dynamic(codes: np.ndarray, repeats: int):
    """Interleaved insert/query/remove rounds (BASELINE config 2); the
    workload definition matches bench/baseline.cpp run_dynamic exactly."""
    from cbl_tpu import CBL

    k = 25
    sb = len(codes) // SEGS
    best = None
    for r_i in range(repeats):
        idx = CBL(k=k)
        t0 = time.time()
        ops = positive = 0
        off1 = np.array([0, sb], dtype=np.int64)
        off_h = np.array([0, sb // 2], dtype=np.int64)
        segs = [idx.pack_stream(codes[i * sb : (i + 1) * sb], off1)
                for i in range(SEGS)]
        halves = [idx.pack_stream(codes[i * sb : i * sb + sb // 2], off_h)
                  for i in range(SEGS)]
        pos_dev = None
        for i in range(SEGS):
            # fused round: ONE device program for insert+query+remove
            t, p = idx.dynamic_round(
                segs[i], segs[i - 1 if i else 0], halves[i], lazy=True
            )
            pos_dev = p if pos_dev is None else pos_dev + p
            ops += 2 * (sb - k + 1) + sb // 2 - k + 1
        import jax

        # single-sync: the distinct count (slog scan) and the positive
        # total come back in ONE device_get
        n, positive = (
            int(x) for x in jax.device_get((idx.count_device(), pos_dev))
        )
        total_s = time.time() - t0
        r = {"ops": ops, "distinct": n, "positive": positive,
             "total_s": total_s}
        print(f"  dynamic repeat {r_i}: {total_s:.3f}s", file=sys.stderr)
        if best is None or r["total_s"] < best["total_s"]:
            best = r
    return best


def run_device_sharded_dynamic(codes: np.ndarray, repeats: int,
                               n_devices: int = 1):
    """The dynamic workload on ShardedCBL (sharded sorted-log rounds) —
    same op stream as run_device_dynamic."""
    import jax

    from cbl_tpu.parallel import ShardedCBL, make_mesh

    k = 25
    sb = len(codes) // SEGS
    mesh = make_mesh(jax.devices()[:n_devices])
    off1 = np.array([0, sb], dtype=np.int64)
    off_h = np.array([0, sb // 2], dtype=np.int64)
    best = None
    for r_i in range(repeats):
        idx = ShardedCBL(k=k, mesh=mesh)
        t0 = time.time()
        ops = 0
        pos_dev = None
        segs = [idx.pack_stream(codes[i * sb:(i + 1) * sb], off1)
                for i in range(SEGS)]
        halves = [idx.pack_stream(codes[i * sb:i * sb + sb // 2], off_h)
                  for i in range(SEGS)]
        for i in range(SEGS):
            t, p = idx.dynamic_round(
                segs[i], segs[i - 1 if i else 0], halves[i], lazy=True,
            )
            pos_dev = p if pos_dev is None else pos_dev + p
            ops += 2 * (sb - k + 1) + sb // 2 - k + 1
        live, pos = jax.device_get((idx._slog_live_dev, pos_dev))
        n, positive = int(np.asarray(live)[0]), int(np.asarray(pos)[0])
        total_s = time.time() - t0
        r = {"ops": ops, "distinct": n, "positive": positive,
             "total_s": total_s}
        print(f"  sharded-dynamic repeat {r_i} (D={n_devices}): "
              f"{total_s:.3f}s", file=sys.stderr)
        if best is None or r["total_s"] < best["total_s"]:
            best = r
    return best


def collect_sharded_dynamic(args, codes, base=None) -> dict:
    if base is None and not args.skip_baseline:
        base = run_baseline_dynamic(codes)
        print(f"baseline dynamic: {base}", file=sys.stderr)
    ours = run_device_sharded_dynamic(codes, args.repeats)
    print(f"cbl_tpu sharded-dynamic: {ours}", file=sys.stderr)
    if base is not None:
        assert ours["distinct"] == base["distinct"], (ours, base)
        assert ours["positive"] == base["positive"], (ours, base)
        vs = (ours["ops"] / ours["total_s"]) / base["ops_per_s"]
    else:
        vs = None
    return {"ops_per_s": ours["ops"] / ours["total_s"], "vs_local": vs,
            "base": base}


def mode_sharded_dynamic(args, codes):
    r = collect_sharded_dynamic(args, codes)
    print(json.dumps({
        "metric": "SHARDED (D=1 mesh) interleaved insert/remove/query "
        f"ops/s (K=25, {args.bases/1e6:.0f}Mbp, {SEGS} rounds)",
        "value": round(r["ops_per_s"], 1),
        "unit": "kmer-ops/s",
        "vs_baseline": round(r["vs_local"], 3) if r["vs_local"] else None,
    }))


def collect_dynamic(args, codes, base=None) -> dict:
    if base is None and not args.skip_baseline:
        base = run_baseline_dynamic(codes)
        print(f"baseline dynamic: {base}", file=sys.stderr)
    ours = run_device_dynamic(codes, args.repeats)
    print(f"cbl_tpu dynamic: {ours}", file=sys.stderr)
    if base is not None:
        assert ours["distinct"] == base["distinct"], (ours, base)
        assert ours["positive"] == base["positive"], (ours, base)
        vs = (ours["ops"] / ours["total_s"]) / base["ops_per_s"]
    else:
        vs = None
    return {"ops_per_s": ours["ops"] / ours["total_s"], "vs_local": vs,
            "base": base}


def mode_dynamic(args, codes):
    r = collect_dynamic(args, codes)
    print(json.dumps({
        "metric": "interleaved insert/remove/query ops/s (K=25, "
        f"{args.bases/1e6:.0f}Mbp, {SEGS} rounds)",
        "value": round(r["ops_per_s"], 1),
        "unit": "kmer-ops/s",
        "vs_baseline": round(r["vs_local"], 3) if r["vs_local"] else None,
    }))


def mode_largek(args, codes):
    """BASELINE config 3: K=59 build + full enumeration (list)."""
    from cbl_tpu import CBL

    import jax

    k = 59
    offsets = np.array([0, len(codes)], dtype=np.int64)
    nk = len(codes) - k + 1
    best = None
    for r_i in range(args.repeats):
        idx = CBL(k=k, prefix_bits=28)
        t0 = time.time()
        idx.insert_codes_stream(codes, offsets)
        n = int(jax.device_get(idx.count_device()))  # single scalar sync
        t1 = time.time()
        lst = idx.kmers_limbs()
        t2 = time.time()
        assert lst.shape[0] == n
        r = {"distinct": n, "build_s": t1 - t0, "list_s": t2 - t1}
        print(f"  largek repeat {r_i}: {r}", file=sys.stderr)
        if best is None or r["build_s"] + r["list_s"] < (
            best["build_s"] + best["list_s"]
        ):
            best = r
    print(json.dumps({
        "metric": f"K=59 build+list k-mers/s ({args.bases/1e6:.0f}Mbp)",
        "value": round((nk + best["distinct"]) /
                       (best["build_s"] + best["list_s"]), 1),
        "unit": "kmers/s",
        "vs_baseline": None,
    }))


def collect_algebra(args, codes) -> dict:
    """BASELINE config 4: two-index union/inter/diff/symdiff + serde."""
    from cbl_tpu import CBL

    half = len(codes) // 2
    a = CBL(k=25)
    a.insert_codes_stream(codes[:half], np.array([0, half], dtype=np.int64))
    b = CBL(k=25)
    b.insert_codes_stream(codes[half:], np.array([0, len(codes) - half],
                                                 dtype=np.int64))
    na, nb = a.count(), b.count()
    rows = {}
    for name, op in (("union", lambda: a | b), ("inter", lambda: a & b),
                     ("diff", lambda: a - b), ("symdiff", lambda: a ^ b)):
        ts = []
        for _ in range(args.repeats):
            t0 = time.time()
            c = op()
            c.count()
            ts.append(time.time() - t0)
        rows[name] = min(ts)
        print(f"  {name}: {rows[name]*1e3:.0f}ms", file=sys.stderr)
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        t0 = time.time()
        a.save_to_file(os.path.join(td, "bench_a.cblx.npz"))
        a2 = CBL.load_from_file(os.path.join(td, "bench_a.cblx.npz"))
        assert a2.count() == na
        rows["serde_s"] = time.time() - t0
    print(f"  serde round-trip: {rows['serde_s']:.2f}s ({na} kmers)",
          file=sys.stderr)
    rows["na"], rows["nb"] = na, nb
    return rows


def mode_algebra(args, codes):
    rows = collect_algebra(args, codes)
    na, nb = rows["na"], rows["nb"]
    total_rows = 4 * (na + nb)
    algebra_s = sum(rows[k_] for k_ in ("union", "inter", "diff", "symdiff"))
    print(json.dumps({
        "metric": "set-algebra rows/s over 4 ops "
        f"(2x{na/1e6:.1f}M kmers) + serde",
        "value": round(total_rows / algebra_s, 1),
        "unit": "rows/s",
        "vs_baseline": None,
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bases", type=int, default=32_000_000)
    ap.add_argument("--chunk", type=int, default=1 << 19)
    ap.add_argument("--pending-cap", type=int, default=1 << 21)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--canonical", action="store_true",
                    help="canonical (strand-folded) k-mers for static/"
                    "genome modes; counts cross-checked against the "
                    "baseline's min(kmer, revcomp) oracle")
    ap.add_argument("--headline-only", action="store_true",
                    help="default mode: print only the static headline "
                    "(skip the dynamic/genome/algebra/canonical extra "
                    "keys measured in the same session)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of the benched "
                    "workload into DIR (cbl_tpu.profiling)")
    ap.add_argument(
        "--mode", default="static",
        choices=["static", "dynamic", "largek", "algebra", "genome",
                 "sharded-dynamic"],
        help="static = BASELINE config 1 (driver headline); dynamic/largek/"
        "algebra = configs 2-4 (recorded in BASELINE.md); genome = config 1 "
        "on repeat-rich multi-record data with ~50% query hit rate",
    )
    args = ap.parse_args()

    if args.trace:
        from cbl_tpu.profiling import trace

        print(f"tracing into {args.trace}", file=sys.stderr)
        with trace(args.trace):
            return _run_mode(args)
    return _run_mode(args)


def _run_mode(args):
    if args.mode == "genome":
        return mode_genome(args)
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=args.bases, dtype=np.uint8)
    if args.mode == "dynamic":
        return mode_dynamic(args, codes)
    if args.mode == "sharded-dynamic":
        return mode_sharded_dynamic(args, codes)
    if args.mode == "largek":
        return mode_largek(args, codes)
    if args.mode == "algebra":
        return mode_algebra(args, codes)
    st = collect_static(args, codes, canonical=args.canonical)
    canon = ", canonical" if args.canonical else ""
    out = {
        "metric": "insert_seq+contains_seq k-mers/s per chip (K=25"
        f"{canon}, {args.bases/1e6:.0f}Mbp synthetic)",
        "value": round(st["kmers_per_s"], 1),
        "unit": "kmers/s",
        "vs_baseline": (
            round(st["vs_baseline"], 3) if st["vs_baseline"] else None
        ),
    }
    if not args.headline_only and not args.canonical:
        # Same-session extras (round-4 verdict item 2): every north-star
        # number in ONE driver-verifiable JSON line, counts cross-checked
        # against bench/baseline.cpp the same way the headline is.  An
        # extra that fails fails the run.
        def extra(name, fn):
            out.update(fn())

        def canonical_extra():
            c = collect_static(args, codes, canonical=True)
            return {
                "canonical_kmers_per_s": round(c["kmers_per_s"], 1),
                "canonical_vs_baseline": (
                    round(c["vs_baseline"], 3) if c["vs_baseline"] else None
                ),
            }

        dyn_state = {}

        def dynamic_extra():
            d = collect_dynamic(args, codes)
            dyn_state["base"] = d["base"]
            dyn_state["ops_per_s"] = d["ops_per_s"]
            return {
                "dynamic_ops_per_s": round(d["ops_per_s"], 1),
                "dynamic_vs_local": (
                    round(d["vs_local"], 3) if d["vs_local"] else None
                ),
            }

        def sharded_dynamic_extra():
            s = collect_sharded_dynamic(
                args, codes, base=dyn_state.get("base")
            )
            r = {"sharded_dynamic_ops_per_s": round(s["ops_per_s"], 1)}
            if dyn_state.get("ops_per_s"):
                r["sharded_dynamic_ratio"] = round(
                    s["ops_per_s"] / dyn_state["ops_per_s"], 3
                )
            return r

        def genome_extra():
            g = collect_genome(args)
            return {
                "genome_kmers_per_s": round(g["kmers_per_s"], 1),
                "genome_vs_baseline": (
                    round(g["vs_baseline"], 3) if g["vs_baseline"] else None
                ),
            }

        def algebra_extra():
            rows = collect_algebra(args, codes)
            return {
                "algebra_ms": {
                    k_: round(rows[k_] * 1e3, 1)
                    for k_ in ("union", "inter", "diff", "symdiff")
                },
                "serde_s": round(rows["serde_s"], 3),
            }

        extra("canonical", canonical_extra)
        extra("dynamic", dynamic_extra)
        extra("sharded_dynamic", sharded_dynamic_extra)
        extra("genome", genome_extra)
        extra("algebra", algebra_extra)
    print(json.dumps(out))


def collect_static(args, codes, canonical: bool = False) -> dict:
    n_kmers = args.bases - 25 + 1
    base = None
    label = " canonical" if canonical else ""
    if not args.skip_baseline:
        base = run_baseline(codes, canonical=canonical)
        print(f"baseline{label} (1 CPU core): {base}", file=sys.stderr)
    ours = run_device(codes, args.chunk, args.pending_cap, args.repeats,
                   canonical=canonical)
    print(f"cbl_tpu{label}: {ours}", file=sys.stderr)
    if base is not None:
        assert ours["distinct"] == base["distinct"], (
            f"COUNT MISMATCH: device={ours['distinct']} cpu={base['distinct']}"
        )
    assert ours["positive"] == ours["total"] == n_kmers, (
        f"query mismatch: {ours}"
    )
    combined = 2 * n_kmers / (ours["insert_s"] + ours["query_s"])
    if base is not None:
        base_combined = 2 * n_kmers / (base["insert_s"] + base["query_s"])
        vs = combined / base_combined
    else:
        vs = None
    return {"kmers_per_s": combined, "vs_baseline": vs}


if __name__ == "__main__":
    main()
