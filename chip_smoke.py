#!/usr/bin/env python
"""Smoke run of the k-mer set engine on one NVIDIA GPU, at real sizes.

    python chip_smoke.py               # phases (a)-(g) on one GPU
    python chip_smoke.py --four-cards  # the sharded path on four GPUs
    python chip_smoke.py --rehearse    # tiny sizes on whatever JAX finds

Every phase drives the public entry points (`CBL`, `ShardedCBL`, the CLI)
and checks exact counts against a reference that shares no code with the
engine: `bench/baseline.cpp` (K=25), numpy set arithmetic over packed k-mer
integers, or a Python set.

  (a) K=25 bulk build of 2^28 uniform k-mers: 8 slabs of 2^25 folded
      through the merge.
  (b) fold of a 2^25-k-mer genome corpus into that index, then a query of
      its ~50%-hit read set (2^25 k-mers).
  (c) three dynamic rounds over a 2^24-row sorted log.
  (d) union and intersection with a second 2^25-k-mer index; a
      save/load round trip of it.
  (e) K=59 canonical build, query and chunked listing of 2^24 k-mers.
  (f) the CLI (`build`, `count`, `query`) on a seeded gzipped FASTQ.
  (g) the hand-written kernels (merge, necklace) against plain XLA at the
      engine's widths.

Without a GPU (and without --rehearse) it exits non-zero and prints no
result.  The last line of its output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io as pyio
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

FULL = dict(
    a_kmers=1 << 28, slab=None, genome_bases=1 << 25, qread=2048,
    read=65_536, log_kmers=1 << 24, round_kmers=1 << 21,
    b_kmers=1 << 25, k59_kmers=1 << 24, fastq_reads=20_000,
    merge_shapes=((2, 1 << 25, 1 << 25), (2, 1 << 28, 1 << 25),
                  (2, 1 << 24, 3 << 21), (4, 1 << 24, 1 << 24)),
    neck_shapes=((50, 2, 1 << 25), (118, 4, 1 << 25)),
    shard_kmers_per_card=1 << 25,
)
REHEARSE = dict(
    a_kmers=1 << 16, slab=1 << 13, genome_bases=1 << 14, qread=256,
    read=2048, log_kmers=1 << 14, round_kmers=1 << 11,
    b_kmers=1 << 15, k59_kmers=1 << 14, fastq_reads=64,
    merge_shapes=((2, 1 << 12, 1 << 11), (4, 1 << 11, 1 << 11)),
    neck_shapes=((50, 2, 1 << 10), (118, 4, 1 << 10)),
    shard_kmers_per_card=1 << 14,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_lines() -> list[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
        return [ln.strip() for ln in out.splitlines() if ln.strip()]
    except (OSError, subprocess.SubprocessError):
        return ["nvidia-smi: not available"]


def peak_bytes(devices) -> str:
    peaks = []
    for d in devices:
        stats = d.memory_stats() or {}
        if "peak_bytes_in_use" not in stats:
            return "not measured"
        peaks.append(stats["peak_bytes_in_use"])
    return " ".join(f"{p / 2**30:.3f}GiB" for p in peaks)


# --- plain references --------------------------------------------------------


def uniform_codes(n_bases: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, n_bases, dtype=np.uint8)


def valid_starts(offsets: np.ndarray, n_bases: int, k: int) -> np.ndarray:
    """Start positions of k-mers that lie inside one record."""
    starts = np.arange(max(n_bases - k + 1, 0), dtype=np.int64)
    rec = np.searchsorted(offsets, starts, side="right")
    rec_end = np.searchsorted(offsets, starts + k - 1, side="right")
    return starts[rec == rec_end]


def kmer_values(codes: np.ndarray, starts: np.ndarray, k: int) -> np.ndarray:
    """uint64 value of the k-mer at each start (k <= 32, 2 bits a base)."""
    n = len(codes) - k + 1
    c = codes.astype(np.uint64)
    v = np.zeros(n, np.uint64)
    for j in range(k):
        v <<= np.uint64(2)
        v |= c[j: j + n]
    return v[starts]


def _rev2(x: np.ndarray) -> np.ndarray:
    """Reverse the order of the 32 two-bit groups of each uint64."""
    m2, m4 = np.uint64(0x3333333333333333), np.uint64(0x0F0F0F0F0F0F0F0F)
    x = ((x >> np.uint64(2)) & m2) | ((x & m2) << np.uint64(2))
    x = ((x >> np.uint64(4)) & m4) | ((x & m4) << np.uint64(4))
    return x.byteswap()


def canonical_of(hi: np.ndarray, lo: np.ndarray, k: int):
    """min(x, revcomp(x)) of k-mers given as (hi, lo) uint64 pairs (lo: the
    last 32 bases; 32 < k <= 64).  Codes are A=0 C=1 T=2 G=3, so a base's
    complement is code ^ 2."""
    s = np.uint64(128 - 2 * k)
    rhi, rlo = _rev2(lo), _rev2(hi)  # the value now sits in the top 2k bits
    rlo = (rlo >> s) | (rhi << (np.uint64(64) - s))
    rhi = rhi >> s
    rlo ^= np.uint64(0xAAAAAAAAAAAAAAAA)
    rhi ^= np.uint64(0xAAAAAAAAAAAAAAAA & ((1 << (2 * k - 64)) - 1))
    take = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    return np.where(take, rhi, hi), np.where(take, rlo, lo)


def canonical_pairs(codes: np.ndarray, starts: np.ndarray, k: int):
    """Canonical (hi, lo) of the k-mer at each start (32 < k <= 64)."""
    n = len(codes) - k + 1
    c = codes.astype(np.uint64)
    hi = np.zeros(n, np.uint64)
    lo = np.zeros(n, np.uint64)
    for j in range(k - 32):
        hi <<= np.uint64(2)
        hi |= c[j: j + n]
    for j in range(k - 32, k):
        lo <<= np.uint64(2)
        lo |= c[j: j + n]
    return canonical_of(hi[starts], lo[starts], k)


def unique_pairs(hi: np.ndarray, lo: np.ndarray):
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    keep = np.ones(len(hi), bool)
    keep[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    return hi[keep], lo[keep]


def pairs_in(q_hi, q_lo, s_hi, s_lo) -> np.ndarray:
    """Membership of each (hi, lo) query pair in a set of unique pairs:
    sort both together, set rows first within equal runs."""
    hi = np.concatenate([s_hi, q_hi])
    lo = np.concatenate([s_lo, q_lo])
    is_q = np.concatenate([np.zeros(len(s_hi), bool),
                           np.ones(len(q_hi), bool)])
    order = np.lexsort((is_q, lo, hi))
    hi, lo, is_q = hi[order], lo[order], is_q[order]
    start = np.ones(len(hi), bool)
    start[1:] = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    run_has_set = ~is_q[np.flatnonzero(start)][np.cumsum(start) - 1]
    hit = np.empty(len(q_hi), bool)
    hit[order[is_q] - len(s_hi)] = run_has_set[is_q]
    return hit


def start_baseline(codes_i, off_i, codes_q=None, off_q=None):
    """Start bench/baseline.cpp in the background (it needs no device)."""
    import bench

    exe = bench.build_baseline()
    td = tempfile.mkdtemp(prefix="chip_smoke_")
    paths = []
    arrays = [codes_i] if codes_q is None else [codes_i, off_i, codes_q, off_q]
    for i, arr in enumerate(arrays):
        p = os.path.join(td, f"in{i}.bin")
        arr.tofile(p)
        paths.append(p)
    args = paths if codes_q is None else [paths[0], "records", *paths[1:]]
    proc = subprocess.Popen([exe, *args], stdout=subprocess.PIPE, text=True)
    return proc, td


def baseline_result(started) -> dict:
    import shutil

    proc, td = started
    try:
        out, _ = proc.communicate(timeout=1100)
    finally:
        proc.kill()
        shutil.rmtree(td, ignore_errors=True)
    if proc.returncode != 0:
        raise RuntimeError(f"baseline exited {proc.returncode}")
    return json.loads(out)


# --- phases -----------------------------------------------------------------


class Check:
    """Collects phase results; a phase fails on any count mismatch."""

    def __init__(self, devices):
        self.devices = devices
        self.failed = []

    def phase(self, name: str, fn):
        t0 = time.perf_counter()
        try:
            pairs = fn()
        except Exception as e:  # a failing phase fails the run
            import traceback

            traceback.print_exc()
            self.failed.append(name)
            log(f"[{name}] FAILED: {type(e).__name__}: {e}")
            return
        dt = time.perf_counter() - t0
        ok = all(got == want for _, got, want in pairs)
        for what, got, want in pairs:
            log(f"[{name}] {what}: got {got} oracle {want}"
                f"{'' if got == want else '  MISMATCH'}")
        log(f"[{name}] {'ok' if ok else 'FAILED'} in {dt:.3f}s wall; "
            f"peak device memory so far {peak_bytes(self.devices)}")
        if not ok:
            self.failed.append(name)


def phase_ab(sz, state):
    """(a) multi-slab K=25 build, (b) genome fold + ~50%-hit query."""
    import bench
    from cbl_tpu import CBL

    k = 25
    u = uniform_codes(sz["a_kmers"] + k - 1, seed=1)
    u_off = np.array([0, len(u)], np.int64)
    g, g_off, q, q_off = bench.make_genome_corpus(
        sz["genome_bases"], seed=2, read_len=sz["read"], qread_len=sz["qread"]
    )
    base_a = start_baseline(u, u_off)
    codes_i = np.concatenate([u, g])
    off_i = np.concatenate([u_off, len(u) + g_off[1:]])
    base_b = start_baseline(codes_i, off_i, q, q_off)

    idx = CBL(k=k, prefix_bits=24)
    t0 = time.perf_counter()
    idx.insert_codes_stream(u, u_off)
    n_a = idx.count()
    t_a = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.insert_codes_stream(g, g_off)
    n_b = idx.count()
    total, positive = idx.query_codes_stream(q, q_off)
    t_b = time.perf_counter() - t0
    log(f"[a] build of {sz['a_kmers']} k-mers: {t_a:.3f}s wall; "
        f"[b] fold + query: {t_b:.3f}s wall")
    ra, rb = baseline_result(base_a), baseline_result(base_b)
    n_q = int(sum(max(int(q_off[i + 1] - q_off[i]) - k + 1, 0)
                  for i in range(len(q_off) - 1)))
    log(f"[b] query hit rate {positive / max(total, 1):.4f}")
    return [
        ("a distinct k-mers", n_a, ra["distinct"]),
        ("b distinct k-mers after the genome fold", n_b, rb["distinct"]),
        ("b query total", total, n_q),
        ("b query positive", positive, rb["positive"]),
    ]


def _round_streams(sz, r, log_codes):
    k = 25
    n = sz["round_kmers"] + k - 1
    one = lambda c: (c, np.array([0, len(c)], np.int64))  # noqa: E731
    ins = uniform_codes(n, seed=100 + r)
    # queries: half this round's inserts, half fresh bases (two records)
    qry = np.concatenate([ins[: n // 2], uniform_codes(n - n // 2, 200 + r)])
    qoff = np.array([0, n // 2, n], np.int64)
    lo = r * sz["round_kmers"]
    rm = log_codes[lo: lo + n]  # removes hit the pre-existing index
    return one(ins), (qry, qoff), one(rm)


def phase_c(sz, state):
    """(c) three fused dynamic rounds over a 2^24-row sorted log."""
    from cbl_tpu import CBL

    k = 25
    base = uniform_codes(sz["log_kmers"] + k - 1, seed=3)
    idx = CBL(k=k, prefix_bits=24)
    idx.insert_codes_stream(base, np.array([0, len(base)], np.int64))
    want = np.unique(kmer_values(base, np.arange(sz["log_kmers"]), k))
    pairs = [("c index before the rounds", idx.count(), len(want))]
    streams = [_round_streams(sz, r, base) for r in range(3)]
    t0 = time.perf_counter()
    got_rounds = [idx.dynamic_round(*s) for s in streams]
    log(f"[c] three rounds: {time.perf_counter() - t0:.3f}s wall")
    for r, ((ins, ioff), (qry, qoff), (rm, roff)) in enumerate(streams):
        want = np.union1d(want, kmer_values(
            ins, valid_starts(ioff, len(ins), k), k))
        qv = kmer_values(qry, valid_starts(qoff, len(qry), k), k)
        pairs.append((f"c round {r} (total, positive)", got_rounds[r],
                      (len(qv), int(np.isin(qv, want).sum()))))
        want = np.setdiff1d(want, kmer_values(
            rm, valid_starts(roff, len(rm), k), k))
    pairs.append(("c distinct after the rounds", idx.count(), len(want)))
    state["c_index"], state["c_set"] = idx, want
    return pairs


def phase_d(sz, state):
    """(d) union and intersection with a second index; save/load of it."""
    from cbl_tpu import CBL

    k = 25
    c_idx, c_set = state["c_index"], state["c_set"]
    half = sz["b_kmers"] // 2
    overlap = uniform_codes(sz["log_kmers"] + k - 1, seed=3)[: half + k - 1]
    codes = np.concatenate([overlap, uniform_codes(half, seed=4)])
    off = np.array([0, len(overlap), len(codes)], np.int64)
    b = CBL(k=k, prefix_bits=24)
    b.insert_codes_stream(codes, off)
    b_set = np.unique(kmer_values(codes, valid_starts(off, len(codes), k), k))
    u = c_idx | b
    i = c_idx & b
    pairs = [
        ("d second index distinct", b.count(), len(b_set)),
        ("d union", u.count(), len(np.union1d(c_set, b_set))),
        ("d intersection", i.count(), len(np.intersect1d(c_set, b_set))),
    ]
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "b.cblx.npz")
        b.save_to_file(path)
        back = CBL.load_from_file(path)
        n_valid = len(valid_starts(off, len(codes), k))
        pairs += [
            ("d reloaded distinct", back.count(), len(b_set)),
            ("d reloaded self-query (total, positive)",
             back.query_codes_stream(codes, off), (n_valid, n_valid)),
        ]
    return pairs


def phase_e(sz, state):
    """(e) K=59 canonical build, query and chunked listing."""
    from cbl_tpu import CBL
    from cbl_tpu.necklace import np_word_to_kmer

    k = 59
    n = sz["k59_kmers"]
    s = uniform_codes(n + k - 1, seed=5)
    w = n // 4
    seg = (s[: w + k - 1] ^ 2)[::-1]  # reverse complements of the first w
    s[3 * w: 3 * w + len(seg)] = seg
    s_off = np.array([0, len(s)], np.int64)
    rc_window = (s[w: 2 * w + k - 1] ^ 2)[::-1].copy()  # all hits
    q = np.concatenate([rc_window, uniform_codes(w + k - 1, seed=6)])
    q_off = np.array([0, len(rc_window), len(q)], np.int64)

    idx = CBL.new_canonical(k=k, prefix_bits=28)
    t0 = time.perf_counter()
    idx.insert_codes_stream(s, s_off)
    n_got = idx.count()
    total, positive = idx.query_codes_stream(q, q_off)
    listed = [np_word_to_kmer(c, idx.cfg)
              for c in idx.wordset.iter_words_chunks(1 << 22)]
    log(f"[e] build + query + list: {time.perf_counter() - t0:.3f}s wall")
    t0 = time.perf_counter()
    want_hi, want_lo = unique_pairs(*canonical_pairs(s, np.arange(n), k))
    q_hi, q_lo = canonical_pairs(q, valid_starts(q_off, len(q), k), k)
    hit = pairs_in(q_hi, q_lo, want_hi, want_lo)
    # listed k-mer limbs -> the same canonical (hi, lo) form
    limbs = np.concatenate(listed).astype(np.uint64)
    lhi, llo = unique_pairs(*canonical_of(
        (limbs[:, 0] << np.uint64(32)) | limbs[:, 1],
        (limbs[:, 2] << np.uint64(32)) | limbs[:, 3], k))
    same = bool(np.array_equal(lhi, want_hi) and np.array_equal(llo, want_lo))
    log(f"[e] oracle: {time.perf_counter() - t0:.3f}s wall")
    return [
        ("e distinct canonical k-mers", n_got, len(want_hi)),
        ("e query (total, positive)", (total, positive),
         (len(q_hi), int(hit.sum()))),
        ("e listed rows", len(limbs), len(want_hi)),
        ("e listed set equals the oracle's", same, True),
    ]


def phase_f(sz, state):
    """(f) the CLI on a seeded gzipped FASTQ: build, count, query."""
    from cbl_tpu import cli, io as cio

    k = 25
    rng = np.random.default_rng(7)
    reads = []
    for _ in range(sz["fastq_reads"]):
        r = rng.choice(np.frombuffer(b"ACGT", np.uint8), rng.integers(80, 400))
        r[rng.random(len(r)) < 0.01] = ord("N")  # Ns are dropped, not split
        reads.append(r.tobytes())
    queries = reads[::2] + [
        rng.choice(np.frombuffer(b"ACGT", np.uint8), 300).tobytes()
        for _ in range(len(reads) // 2)
    ]
    log(f"[f] FASTA/Q parser: {cio.parser_kind()}")

    def fastq(rs):
        return b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s))
                        for i, s in enumerate(rs))

    def kmers(rs):
        out = []
        for s in rs:
            s = bytes(c for c in s if c in b"ACGT")
            out += [s[i:i + k] for i in range(len(s) - k + 1)]
        return out

    want = set(kmers(reads))
    qk = kmers(queries)
    with tempfile.TemporaryDirectory() as td:
        fq, qfq, idx = (os.path.join(td, n)
                        for n in ("reads.fq.gz", "q.fq.gz", "i.cblx"))
        with gzip.open(fq, "wb") as f:
            f.write(fastq(reads))
        with gzip.open(qfq, "wb") as f:
            f.write(fastq(queries))
        assert cli.main(["build", fq, "-o", idx]) == 0
        out, err = pyio.StringIO(), pyio.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert cli.main(["count", idx]) == 0
            assert cli.main(["query", idx, qfq]) == 0
    lines = err.getvalue().splitlines()
    q_total = int(next(ln for ln in lines if ln.startswith("# queries:"))
                  .split()[-1])
    q_pos = int(next(ln for ln in lines
                     if ln.startswith("# positive queries:")).split()[3])
    return [
        ("f count", int(out.getvalue().split()[0]), len(want)),
        ("f query (total, positive)", (q_total, q_pos),
         (len(qk), sum(x in want for x in qk))),
    ]


def phase_g(sz, state):
    """(g) the kernels against their XLA references at engine widths."""
    from cbl_tpu.ops.kernel_checks import (merge_kernel_check,
                                           necklace_kernel_check)

    pairs = []
    for width, L, n in sz["neck_shapes"]:
        r = necklace_kernel_check(width, L, n, interpret=state["interpret"])
        log(f"[g] necklace {width}-bit x {n}: kernel {r['kernel_ms']:.3f} ms"
            f", XLA chain {r['chain_ms']:.3f} ms (median of 5)")
        pairs.append((f"g necklace {width}-bit equals the chain", r["ok"],
                      True))
    for L, na, nb in sz["merge_shapes"]:
        r = merge_kernel_check(L, na, nb, interpret=state["interpret"])
        log(f"[g] merge L={L} {na}+{nb} rows: kernel {r['kernel_ms']:.3f} ms"
            f", lax.sort(concat) {r['lax_sort_ms']:.3f} ms (median of 5)")
        pairs.append((f"g merge L={L} {na}+{nb} equals lax.sort", r["ok"],
                      True))
    return pairs


def phase_four_cards(sz, state):
    """The sharded path on a 4-device mesh against a one-device build."""
    import jax

    import __graft_entry__ as g
    from cbl_tpu.parallel import make_mesh

    devices = jax.devices()[:4]
    mesh = make_mesh(devices)
    placed = set()
    t0 = time.perf_counter()

    def progress(line):
        log(f"[4] {time.perf_counter() - t0:8.3f}s {line}")

    n, total = g._dryrun_at_scale(mesh, 4, sz["shard_kmers_per_card"],
                                  placement=placed, progress=progress)
    log(f"[4] sharded index {n} distinct k-mers over {total} k-mers streamed")
    return [("4 shards on distinct devices", placed,
             {d.id for d in devices})]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on whatever device JAX finds (CPU "
                    "rehearsal; proves nothing about a GPU)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    need = 4 if args.four_cards else 1
    if not args.rehearse and (platform != "gpu" or len(devices) < need):
        print(f"chip_smoke: needs {need} GPU(s); JAX found {len(devices)} "
              f"{platform} device(s)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import cbl_tpu  # noqa: F401
        import cbl_tpu.cbl as cbl_mod
    except ImportError as e:
        print(f"chip_smoke: the cbl_tpu package is missing ({e})",
              file=sys.stderr)
        return 2
    sz = REHEARSE if args.rehearse else FULL
    if sz["slab"]:
        cbl_mod._FUSED_SLAB = sz["slab"]  # multi-slab paths at tiny sizes

    for line in card_lines():
        log(line)
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind} "
        f"({platform}){' REHEARSAL' if args.rehearse else ''}")
    state = {"interpret": platform != "gpu"}
    check = Check(devices[:need])
    if args.four_cards:
        check.phase("4", lambda: phase_four_cards(sz, state))
    else:
        for name, fn in (("ab", phase_ab), ("c", phase_c), ("d", phase_d),
                         ("e", phase_e), ("f", phase_f), ("g", phase_g)):
            check.phase(name, lambda fn=fn: fn(sz, state))
            if name == "d":
                state.pop("c_index", None)
    if check.failed:
        log(f"chip_smoke: failed phases: {', '.join(check.failed)}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": need}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
