"""Host I/O: FASTA/FASTQ decoding into device-ready 2-bit code streams.

The reference delegates parsing to the needletail crate
(`/root/reference/examples/cbl.rs:8,112-115`, gzip supported) and feeds
records one at a time to `insert_seq`.  Here the parser's job is bigger: it
must keep the device fed, so it emits one concatenated code stream + record
offsets (the exact format of `CBL.insert_codes_stream`).  A C++ decoder
(`native/fastx.cpp`, built on first use) does the byte crunching; a pure
numpy fallback keeps everything working without a toolchain.
"""

from __future__ import annotations

import gzip
import os
import subprocess
import sys

import numpy as np

from ..kmer import NUC_LOOKUP

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_NATIVE_SRC = os.path.join(_NATIVE_DIR, "fastx.cpp")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")

_native = None
_native_failed = False


def source_keyed_path(src: str, build_dir: str, stem: str,
                      suffix: str = "") -> str:
    """Output path keyed by the source's content hash: an edited source
    builds a new output, and a stale one is never used."""
    import hashlib

    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(build_dir, f"{stem}-{digest}{suffix}")


def build_from_source(src: str, build_dir: str, stem: str, suffix: str = "",
                      flags: tuple = (), libs: tuple = ()) -> str:
    """Compile the C++ file `src` with g++ into `build_dir` unless this
    source was built already; returns the output's path.  Raises on a
    failed build."""
    out = source_keyed_path(src, build_dir, stem, suffix)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", *flags, src, "-o", tmp, *libs]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)  # atomic: no reader sees a partial file
    return out


def native_lib_path(src: str = _NATIVE_SRC,
                    build_dir: str = _BUILD_DIR) -> str:
    """Path of the FASTA/Q library built from `src`."""
    return source_keyed_path(src, build_dir, "_fastx", ".so")


def build_native(src: str = _NATIVE_SRC, build_dir: str = _BUILD_DIR) -> str:
    """Compile `fastx.cpp` into `build_dir` unless this source was built
    already; returns the library path.  Raises on a failed build."""
    return build_from_source(src, build_dir, "_fastx", ".so",
                             flags=("-shared", "-fPIC"), libs=("-lz",))


def _load_native():
    global _native, _native_failed
    if _native is not None or _native_failed:
        return _native
    import ctypes

    try:
        lib_path = build_native()
    except Exception as e:  # toolchain or zlib missing
        print(f"cbl_tpu: native fastx build failed ({e}); using python parser",
              file=sys.stderr)
        _native_failed = True
        return None

    class _Result(ctypes.Structure):
        _fields_ = [
            ("codes", ctypes.POINTER(ctypes.c_uint8)),
            ("n_codes", ctypes.c_uint64),
            ("offsets", ctypes.POINTER(ctypes.c_uint64)),
            ("n_records", ctypes.c_uint64),
            ("error", ctypes.c_int),
        ]

    try:
        lib = ctypes.CDLL(lib_path)
        lib.fastx_parse.restype = ctypes.POINTER(_Result)
        lib.fastx_parse.argtypes = [ctypes.c_char_p]
        lib.fastx_free.argtypes = [ctypes.POINTER(_Result)]
        lib.cbl_pack_stream.restype = None
        lib.cbl_pack_stream.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
        ]
        _native = lib
    except (OSError, AttributeError):  # pragma: no cover
        _native_failed = True
        _native = None
    return _native


def parser_kind() -> str:
    """Which FASTA/Q parser `parse_fastx` runs here: "native" or "python"."""
    return "python" if _load_native() is None else "native"


def pack_stream_native(codes) -> "np.ndarray | None":
    """Native 16-bases/uint32 big-endian pack (see cbl_pack_stream in
    fastx.cpp); None when the native library is unavailable."""
    lib = _load_native()
    if lib is None:
        return None
    import numpy as np

    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    assert len(codes) % 16 == 0
    out = np.empty(len(codes) // 16, dtype=np.uint32)
    lib.cbl_pack_stream(
        codes.ctypes.data, np.uint64(len(codes)), out.ctypes.data
    )
    return out


def parse_fastx(path) -> tuple[np.ndarray, np.ndarray]:
    """Decode a FASTA/FASTQ file (gzip ok) into (codes, offsets).

    codes: [total] uint8 2-bit base codes, invalid characters removed
    (reference filter_map semantics); offsets: [n_records+1] int64 record
    boundaries into codes.
    """
    path = str(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"Failed to open {path}")
    lib = _load_native()
    if lib is not None:
        import ctypes

        res = lib.fastx_parse(path.encode())
        try:
            if res.contents.error:
                raise FileNotFoundError(f"Failed to open {path}")
            n = int(res.contents.n_codes)
            m = int(res.contents.n_records)
            codes = np.ctypeslib.as_array(res.contents.codes, shape=(max(n, 1),))[
                :n
            ].copy()
            offsets = np.ctypeslib.as_array(
                res.contents.offsets, shape=(m + 1,)
            ).astype(np.int64)
            return codes, offsets
        finally:
            lib.fastx_free(res)
    return _parse_fastx_py(path)


def _open_maybe_gzip(path):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _parse_fastx_py(path) -> tuple[np.ndarray, np.ndarray]:
    """Pure-python fallback parser (same output contract)."""
    seqs: list[np.ndarray] = []
    offsets = [0]
    total = 0

    def push(chunks):
        nonlocal total
        if not chunks:
            return
        raw = np.frombuffer(b"".join(chunks), dtype=np.uint8)
        codes = NUC_LOOKUP[raw]
        codes = codes[codes != 255]
        seqs.append(codes)
        total += len(codes)
        offsets.append(total)

    with _open_maybe_gzip(path) as f:
        first = f.readline()
        if not first:
            return np.zeros(0, dtype=np.uint8), np.zeros(1, dtype=np.int64)
        if first.startswith(b">"):
            chunks: list[bytes] = []
            for line in f:
                if line.startswith(b">"):
                    push(chunks)
                    chunks = []
                else:
                    chunks.append(line.strip())
            push(chunks)
        elif first.startswith(b"@"):
            # multi-line FASTQ: sequence lines run until the '+' separator;
            # quality lines run until their raw length matches the sequence
            # (quality lines may begin with '@', so count, don't sniff)
            while True:
                chunks = []
                line = f.readline()
                while line and not line.startswith(b"+"):
                    chunks.append(line.strip())
                    line = f.readline()
                if not chunks:
                    break
                raw_len = sum(len(c) for c in chunks)
                push(chunks)
                got = 0
                while got < raw_len:
                    q = f.readline()
                    if not q:
                        break
                    got += len(q.strip())
                if not f.readline():  # next @header (or EOF)
                    break
        else:
            raise ValueError(f"{path}: not a FASTA/FASTQ file")
    if not seqs:
        return np.zeros(0, dtype=np.uint8), np.zeros(1, dtype=np.int64)
    return np.concatenate(seqs), np.asarray(offsets, dtype=np.int64)


def iter_records(path):
    """Yield per-record [len] uint8 code arrays (convenience/testing)."""
    codes, offsets = parse_fastx(path)
    for i in range(len(offsets) - 1):
        yield codes[offsets[i] : offsets[i + 1]]
