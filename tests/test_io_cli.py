"""FASTA/Q parsing (native C++ + python fallback) and CLI end-to-end,
mirroring the reference CLI contract (`/root/reference/examples/cbl.rs`)."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from cbl_tpu import io as cio
from cbl_tpu.kmer import encode_seq

FASTA = b""">read1 some description
ACGTACGTACGTACGTACGTACGTACGTACGT
>read2
TTTTGGGGCCCCAAAA
acgtn
>read3
GATTACAGATTACAGATTACAGATTACA
"""

FASTQ = b"""@r1
ACGTACGTACGTACGTACGTACGTACGTACGT
+
IIIIIIIIIIIIIIIIIIIIIIIIIIIIIIII
@r2
TTTTGGGGCCCCAAAA
+anything
IIIIIIIIIIIIIIII
"""

# legal multi-line FASTQ: wrapped sequence AND wrapped quality, with a
# quality line that begins with '@' (must be counted, not sniffed)
FASTQ_MULTILINE = b"""@r1 desc
ACGTACGTACGTACGT
ACGTACGTACGT
+
IIIIIIIIIIIIIIII
@IIIIIIIIIII
@r2
TTTTGGGGCCCCAAAA
+
IIIIIIII
IIIIIIII
"""
FASTQ_MULTILINE_RECORDS = [b"ACGTACGTACGTACGTACGTACGTACGT", b"TTTTGGGGCCCCAAAA"]


def _expected_records(raw):
    recs = []
    if raw.startswith(b">"):
        cur = []
        for line in raw.split(b"\n"):
            if line.startswith(b">"):
                if cur:
                    recs.append(b"".join(cur))
                cur = []
            else:
                cur.append(line)
        if cur:
            recs.append(b"".join(cur))
    else:
        lines = raw.strip().split(b"\n")
        for i in range(1, len(lines), 4):
            recs.append(lines[i])
    return [encode_seq(r) for r in recs if len(encode_seq(r))]


@pytest.mark.parametrize("payload", [FASTA, FASTQ], ids=["fasta", "fastq"])
@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("backend", ["native", "python"])
def test_parse_fastx(tmp_path, payload, gz, backend):
    p = tmp_path / ("in.gz" if gz else "in.fx")
    data = gzip.compress(payload) if gz else payload
    p.write_bytes(data)
    if backend == "python":
        codes, offsets = cio._parse_fastx_py(str(p))
    else:
        if cio._load_native() is None:
            pytest.skip("native parser unavailable")
        codes, offsets = cio.parse_fastx(str(p))
    expect = _expected_records(payload)
    assert len(offsets) - 1 == len(expect)
    for i, e in enumerate(expect):
        got = codes[offsets[i] : offsets[i + 1]]
        np.testing.assert_array_equal(got, e, err_msg=f"record {i}")


@pytest.mark.parametrize("backend", ["native", "python"])
def test_parse_fastq_multiline(tmp_path, backend):
    p = tmp_path / "ml.fq"
    p.write_bytes(FASTQ_MULTILINE)
    if backend == "python":
        codes, offsets = cio._parse_fastx_py(str(p))
    else:
        if cio._load_native() is None:
            pytest.skip("native parser unavailable")
        codes, offsets = cio.parse_fastx(str(p))
    expect = [encode_seq(r) for r in FASTQ_MULTILINE_RECORDS]
    assert len(offsets) - 1 == len(expect)
    for i, e in enumerate(expect):
        np.testing.assert_array_equal(
            codes[offsets[i] : offsets[i + 1]], e, err_msg=f"record {i}"
        )


def test_parse_missing_file():
    with pytest.raises(FileNotFoundError):
        cio.parse_fastx("/nonexistent/nope.fa")


def _run_cli(*args, extra_env=None):
    env = {
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "JAX_PLATFORMS": "cpu",
        "HOME": os.environ.get("HOME", ""),
    }
    if extra_env:
        env.update(extra_env)
    return subprocess.run(
        [sys.executable, "-m", "cbl_tpu", *args],
        capture_output=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env,
        timeout=600,
    )


def test_cli_end_to_end(tmp_path):
    rng = np.random.default_rng(0)
    seq = b"".join(
        bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 500)])
        for _ in range(4)
    )
    reads = tmp_path / "reads.fa"
    reads.write_bytes(b">r1\n" + seq[:1000] + b"\n>r2\n" + seq[1000:] + b"\n")
    idx = tmp_path / "idx.cblx.npz"

    r = _run_cli("build", str(reads), "-o", str(idx), "-k", "25")
    assert r.returncode == 0, r.stderr.decode()
    assert b"Building the index of 25-mers" in r.stderr

    r = _run_cli("count", str(idx))
    assert r.returncode == 0
    n = int(r.stdout.strip())
    kmers = set()
    for rec in (seq[:1000], seq[1000:]):
        codes = encode_seq(rec)
        for i in range(len(codes) - 24):
            kmers.add(codes[i : i + 25].tobytes())
    assert n == len(kmers)

    r = _run_cli("query", str(idx), str(reads))
    assert r.returncode == 0
    assert b"# positive queries" in r.stderr
    assert b"(100.00%)" in r.stderr

    r = _run_cli("list", str(idx))
    assert r.returncode == 0
    lines = r.stdout.strip().split(b"\n")
    assert len(lines) == n
    assert {l for l in lines} == {
        bytes(np.frombuffer(b"ACTG", dtype=np.uint8)[np.frombuffer(km, dtype=np.uint8)])
        for km in kmers
    }

    r = _run_cli("repartition", str(idx))
    assert r.returncode == 0
    assert b"prefixes are used" in r.stderr


def test_cli_sharded_repartition(tmp_path):
    """`repartition --sharded` loads a sharded checkpoint, re-balances the
    range partition, and reports the per-shard load before/after."""
    vdev = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    rng = np.random.default_rng(7)
    seq = bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 4000)])
    reads = tmp_path / "reads.fa"
    reads.write_bytes(b">r\n" + seq + b"\n")
    idx = tmp_path / "shidx"
    r = _run_cli("build", str(reads), "-o", str(idx), "--sharded",
                 extra_env=vdev)
    assert r.returncode == 0, r.stderr.decode()
    assert b"Sharding the prefix space across 8 device(s)" in r.stderr
    out = tmp_path / "shidx2"
    r = _run_cli("repartition", str(idx), "--sharded", "-o", str(out),
                 extra_env=vdev)
    assert r.returncode == 0, r.stderr.decode()
    assert b"Shard balance before:" in r.stderr
    assert b"Shard balance after:" in r.stderr
    # the re-balanced checkpoint reloads with the same total count
    before = [
        line for line in r.stderr.split(b"\n")
        if line.startswith(b"Shard balance before:")
    ][0]
    after = [
        line for line in r.stderr.split(b"\n")
        if line.startswith(b"Shard balance after:")
    ][0]
    tot_b = sum(eval(before.split(b":", 1)[1].decode()))
    tot_a = sum(eval(after.split(b":", 1)[1].decode()))
    assert tot_a == tot_b == len(seq) - 24


def test_cli_large_k59(tmp_path):
    # BASELINE.json config 3: K=59, PREFIX_BITS=28, build + list with exact
    # enumeration (u128-class words -> 4 uint32 limbs)
    rng = np.random.default_rng(3)
    seq = bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 400)])
    reads = tmp_path / "r.fa"
    reads.write_bytes(b">r\n" + seq + b"\n")
    idx = tmp_path / "idx59.npz"
    r = _run_cli("build", str(reads), "-o", str(idx), "-k", "59", "--prefix-bits", "28")
    assert r.returncode == 0, r.stderr.decode()
    r = _run_cli("list", str(idx))
    assert r.returncode == 0
    lines = sorted(r.stdout.strip().split(b"\n"))
    expect = sorted({seq[i : i + 59] for i in range(len(seq) - 58)})
    assert lines == expect


def test_cli_set_ops(tmp_path):
    rng = np.random.default_rng(1)
    s1 = bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 600)])
    s2 = bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 600)])
    f1, f2 = tmp_path / "a.fa", tmp_path / "b.fa"
    f1.write_bytes(b">a\n" + s1 + b"\n")
    f2.write_bytes(b">b\n" + s2 + b"\n")
    i1, i2 = tmp_path / "a.npz", tmp_path / "b.npz"
    assert _run_cli("build", str(f1), "-o", str(i1)).returncode == 0
    assert _run_cli("build", str(f2), "-o", str(i2)).returncode == 0

    out = {}
    for op in ["merge", "inter", "diff", "sym-diff"]:
        o = tmp_path / f"{op}.npz"
        assert _run_cli(op, str(i1), str(i2), "-o", str(o)).returncode == 0
        r = _run_cli("count", str(o))
        out[op] = int(r.stdout.strip())
    n1 = int(_run_cli("count", str(i1)).stdout.strip())
    n2 = int(_run_cli("count", str(i2)).stdout.strip())
    assert out["merge"] == out["inter"] + out["sym-diff"]
    assert out["diff"] == n1 - out["inter"]
    assert out["merge"] == n1 + n2 - out["inter"]

    # insert then remove round-trips
    o = tmp_path / "ins.npz"
    assert _run_cli("insert", str(i1), str(f2), "-o", str(o)).returncode == 0
    assert int(_run_cli("count", str(o)).stdout.strip()) == out["merge"]
    o2 = tmp_path / "rm.npz"
    assert _run_cli("remove", str(o), str(f2), "-o", str(o2)).returncode == 0
    assert int(_run_cli("count", str(o2)).stdout.strip()) == out["diff"]
