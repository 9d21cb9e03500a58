"""The port's native PCD parser (``csrc/pcd_native.cpp`` via ``io/native.py``)
against the JAX package's ``read_pcd`` and stage-1 loader, on the CPU.

Arrays are compared byte for byte: the parser copies the files' float32
columns, so nothing may round.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from lidar_slam_arvc_tpu.io.pcd import read_pcd as read_pcd_ref
from lidar_slam_arvc_tpu.pipeline import scanmatcher as sm_ref
from lidar_slam_arvc_tpu_torch.io import native, pcd
from lidar_slam_arvc_tpu_torch.pipeline import scanmatcher as sm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# x, y, z, intensity (F4) and ring (U2): an 18-byte point, so the xyz
# columns are strided and offset within it
FIELDS = np.dtype([("x", "<f4"), ("y", "<f4"), ("ring", "<u2"),
                   ("z", "<f4"), ("intensity", "<f4")])


def lzf_compress(data: bytes) -> bytes:
    """A greedy LZF encoder (literal runs and back references, 3-byte hash),
    enough to exercise every branch of the decoders."""
    out, lit, table = bytearray(), bytearray(), {}
    i, n = 0, len(data)

    def flush():
        for j in range(0, len(lit), 32):
            run = lit[j:j + 32]
            out.append(len(run) - 1)
            out.extend(run)
        lit.clear()

    while i < n:
        ref = table.get(data[i:i + 3]) if i + 3 <= n else None
        if i + 3 <= n:
            table[data[i:i + 3]] = i
        if ref is not None and i - ref <= 8192:
            off, length = i - ref - 1, 3
            while i + length < n and length < 264 and data[ref + length] == data[i + length]:
                length += 1
            flush()
            code = length - 2
            if code < 7:
                out.append((code << 5) | (off >> 8))
            else:
                out.extend([(7 << 5) | (off >> 8), code - 7])
            out.append(off & 0xFF)
            i += length
        else:
            lit.append(data[i])
            i += 1
    flush()
    return bytes(out)


def _header(n: int, kind: str) -> bytes:
    return ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            "FIELDS x y ring z intensity\nSIZE 4 4 2 4 4\nTYPE F F U F F\n"
            f"COUNT 1 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {n}\nDATA {kind}\n").encode()


def write_cloud(path: str, xyz: np.ndarray, kind: str) -> None:
    """An 18-byte-point PCD in ``binary``, ``binary_compressed`` (SoA, LZF)
    or ``ascii`` storage."""
    n = len(xyz)
    rec = np.zeros(n, dtype=FIELDS)
    rec["x"], rec["y"], rec["z"] = xyz.T
    rec["ring"] = np.arange(n) % 16
    rec["intensity"] = 0.5
    with open(path, "wb") as f:
        f.write(_header(n, kind))
        if kind == "binary":
            f.write(rec.tobytes())
        elif kind == "binary_compressed":
            soa = b"".join(rec[name].tobytes() for name in FIELDS.names)
            payload = lzf_compress(soa)
            f.write(np.array([len(payload), len(soa)], "<u4").tobytes() + payload)
        else:
            for r in rec:
                f.write(f"{r['x']:.9g} {r['y']:.9g} {r['ring']} {r['z']:.9g} "
                        f"{r['intensity']:.9g}\n".encode())


@pytest.fixture(scope="module")
def clouds(tmp_path_factory):
    """Files of every storage kind; the clouds repeat rows so that LZF
    finds back references."""
    d = tmp_path_factory.mktemp("pcd")
    rng = np.random.default_rng(0)
    paths = {}
    for k, kind in enumerate(("binary", "binary_compressed", "ascii")):
        xyz = rng.normal(scale=10.0, size=(300 + 7 * k, 3)).astype(np.float32)
        xyz[100:150] = xyz[:50]
        paths[kind] = str(d / f"{kind}.pcd")
        write_cloud(paths[kind], xyz, kind)
    return paths


@pytest.mark.parametrize("kind", ["binary", "binary_compressed"])
def test_native_matches_reference_read_pcd(clouds, kind):
    ref = read_pcd_ref(clouds[kind])
    got = native.read_pcd_xyz(clouds[kind], 4096)
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()
    assert pcd.read_pcd(clouds[kind]).tobytes() == ref.tobytes()


def test_ascii_file_is_rejected_and_parsed_in_python(clouds):
    """The parser refuses ASCII storage (a negative count, a zero row); the
    loader parses that file in Python and counts it."""
    assert native.read_pcd_xyz(clouds["ascii"], 4096) is None
    pts, counts = native.read_pcd_batch([clouds["ascii"]], 512)
    assert counts[0] < 0 and not pts.any()
    got, cnt, n_python = sm._load_paths([clouds["ascii"]], 512)
    ref_pts, ref_mask = sm_ref._load_paths([clouds["ascii"]], 512)
    assert n_python == 1 and cnt[0] == ref_mask.sum()
    assert got.tobytes() == ref_pts.tobytes()
    np.testing.assert_array_equal(read_pcd_ref(clouds["ascii"]),
                                  pcd.read_pcd(clouds["ascii"]))


def test_lzf_decompress_matches_python(rng):
    data = np.repeat(rng.integers(0, 7, 3000, dtype=np.uint8), 3).tobytes()
    comp = lzf_compress(data)
    assert len(comp) < len(data)
    assert native.lzf_decompress(comp, len(data)) == data
    assert pcd.lzf_decompress_py(comp, len(data)) == data


@pytest.mark.parametrize("kind", ["binary", "binary_compressed"])
def test_capacity_truncation(clouds, kind):
    """A file longer than the capacity keeps its first ``capacity`` points,
    as the JAX package's native loader does; the rest of a row is zero."""
    ref = read_pcd_ref(clouds[kind])
    pts, counts = native.read_pcd_batch([clouds[kind]] * 2, 128)
    assert list(counts) == [128, 128]
    for row in pts:
        assert row.tobytes() == ref[:128].tobytes()
    big, counts = native.read_pcd_batch([clouds[kind]], 1024)
    assert counts[0] == len(ref) and not big[0, len(ref):].any()


def test_batch_over_mixed_files(clouds):
    """One batch over every kind, in an order that puts the ASCII file
    between native ones: the port's loader gives the JAX package's stage-1
    loader's stack and mask, byte for byte."""
    paths = [clouds["binary"], clouds["ascii"], clouds["binary_compressed"],
             clouds["binary"], clouds["ascii"]]
    pts, counts, n_python = sm._load_paths(paths, 320)
    ref_pts, ref_mask = sm_ref._load_paths(paths, 320)
    assert n_python == 2
    assert pts.tobytes() == ref_pts.tobytes()
    np.testing.assert_array_equal(np.arange(320) < counts[:, None], ref_mask)


def test_builds_its_own_library_and_never_the_reference_one(clouds):
    """In a fresh interpreter, reading a batch loads the port's library
    from its ``_build/`` and maps no ``native/libpcd_native.so``."""
    code = (
        "import json\n"
        "from lidar_slam_arvc_tpu_torch.io import native\n"
        f"native.read_pcd_batch([{clouds['binary']!r}], 64)\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(native.library()._name)\n"
        "print(json.dumps([l.split()[-1] for l in maps.splitlines()\n"
        "                  if 'pcd_native' in l]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    name, mapped = out.stdout.strip().splitlines()[-2:]
    build = os.path.join(REPO, "lidar_slam_arvc_tpu_torch", "_build")
    assert os.path.dirname(name) == build
    mapped = json.loads(mapped)
    assert mapped and all(os.path.dirname(p) == build for p in mapped)


@pytest.mark.parametrize("cxx", ["false", "no-such-compiler"])
def test_build_failure_raises(tmp_path, monkeypatch, cxx):
    """A compiler that fails or is missing raises; nothing falls back."""
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError):
        native._build(str(tmp_path))
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".so")]
