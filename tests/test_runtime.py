"""How the program meets its machine: the compile cache's location, the
native parser built from its committed source, and `chip_smoke.py`'s
refusal to report without a GPU and its CPU rehearsal."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(args, env_extra=None, cwd=REPO, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=timeout)


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(tmp_path, from_env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache lives
    at a fixed path inside the checkout."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if from_env else {}
    r = _python(["-c", "import cbl_tpu, jax; "
                 "print(jax.config.jax_compilation_cache_dir)"], extra)
    assert r.returncode == 0, r.stderr
    want = str(tmp_path) if from_env else os.path.join(REPO, ".jax_cache")
    assert r.stdout.strip() == want


def test_native_parser_builds_from_source(tmp_path):
    """The FASTA/Q library is compiled from `fastx.cpp` into a directory
    keyed by the source's hash, built once, and parses like the Python
    parser."""
    import ctypes

    from cbl_tpu import io as cio

    lib = cio.build_native(build_dir=str(tmp_path))
    assert os.path.dirname(lib) == str(tmp_path)
    assert os.path.basename(lib) == os.path.basename(cio.native_lib_path())
    mtime = os.path.getmtime(lib)
    assert cio.build_native(build_dir=str(tmp_path)) == lib
    assert os.path.getmtime(lib) == mtime  # not rebuilt
    assert hasattr(ctypes.CDLL(lib), "fastx_parse")
    edited = tmp_path / "fastx.cpp"
    edited.write_bytes(open(cio._NATIVE_SRC, "rb").read() + b"\n// edit\n")
    assert cio.native_lib_path(str(edited), str(tmp_path)) != lib

    fa = tmp_path / "r.fa"
    fa.write_bytes(b">a\nACGTNNacgt\nTTGA\n>b\n\n>c\nGGGCCCAAATTT\n")
    assert cio.parser_kind() == "native"
    got = cio.parse_fastx(str(fa))
    want = cio._parse_fastx_py(str(fa))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_needs_a_gpu(tmp_path, alone):
    """Without a GPU, or without the rest of the repo, the smoke run exits
    non-zero and prints no result."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    r = _python(["chip_smoke.py"], cwd=cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_rehearsal_on_cpu():
    """--rehearse runs every phase at tiny sizes and says `cpu`."""
    r = _python(["chip_smoke.py", "--rehearse"], timeout=1200)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 1}}
    for phase in ("ab", "c", "d", "e", "f", "g"):
        assert any(ln.startswith(f"[{phase}] ok in ") for ln in lines), phase
    assert not any("MISMATCH" in ln for ln in lines)


def test_baseline_builds_from_source(tmp_path):
    """bench/baseline.cpp goes through the same hash-keyed build as the
    parser library: built once into the given directory, then reused."""
    sys.path.insert(0, REPO)
    import bench
    from cbl_tpu import io as cio

    exe = bench.build_baseline(build_dir=str(tmp_path))
    src = os.path.join(REPO, "bench", "baseline.cpp")
    assert exe == cio.source_keyed_path(src, str(tmp_path), "baseline")
    assert os.access(exe, os.X_OK)
    mtime = os.path.getmtime(exe)
    assert bench.build_baseline(build_dir=str(tmp_path)) == exe
    assert os.path.getmtime(exe) == mtime  # not rebuilt
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_chip_smoke_four_cards_rehearsal_on_cpu():
    """--four-cards --rehearse drives the sharded path on four virtual CPU
    devices, one shard each, and every count equals the one-device
    build's."""
    r = _python(["chip_smoke.py", "--four-cards", "--rehearse"],
                {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"},
                timeout=1200)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 4}}
    assert "[4] 4 shards on distinct devices: got {0, 1, 2, 3} oracle " \
           "{0, 1, 2, 3}" in lines
    for step in ("one-device insert", "query", "dynamic round", "remove",
                 "repartition", "union", "checkpoint reloaded"):
        assert any(step in ln for ln in lines), step
