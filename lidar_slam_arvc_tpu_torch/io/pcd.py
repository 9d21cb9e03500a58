"""PCD point-cloud file reader/writer (PCL format v0.7).

Counterpart of ``lidar_slam_arvc_tpu/io/pcd.py``: ``ascii``, ``binary``
and ``binary_compressed`` (LZF) storage, numpy-vectorised parsing, LZF
payloads through the pure-Python decompressor.  Stage 1 and the keyframe
store decode with the native batch parser (``io/native.py``) and come
here only for the files it rejects (ASCII storage, parse errors).
"""

from __future__ import annotations

import os

import numpy as np

_NUMPY_TYPES = {
    ("F", 4): np.float32,
    ("F", 8): np.float64,
    ("I", 1): np.int8,
    ("I", 2): np.int16,
    ("I", 4): np.int32,
    ("I", 8): np.int64,
    ("U", 1): np.uint8,
    ("U", 2): np.uint16,
    ("U", 4): np.uint32,
    ("U", 8): np.uint64,
}


def lzf_decompress_py(data: bytes, expected_length: int) -> bytes:
    """Pure-Python libLZF decompressor (PCL ``binary_compressed`` payloads)."""
    out = bytearray(expected_length)
    i = 0
    o = 0
    n = len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            # literal run of ctrl+1 bytes
            run = ctrl + 1
            out[o:o + run] = data[i:i + run]
            i += run
            o += run
        else:
            # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            length += 2
            # overlapping copy must be byte-sequential
            if ref + length <= o:
                out[o:o + length] = out[ref:ref + length]
                o += length
            else:
                for _ in range(length):
                    out[o] = out[ref]
                    o += 1
                    ref += 1
    return bytes(out[:o])


def _parse_header(f):
    header = {}
    while True:
        line = f.readline().decode("ascii", errors="replace").strip()
        if line.startswith("#") or len(line) == 0:
            continue
        key, _, value = line.partition(" ")
        key = key.upper()
        header[key] = value
        if key == "DATA":
            break
    return header


def read_pcd(path: str, fields=("x", "y", "z")) -> np.ndarray:
    """Read a PCD file and return an (N, len(fields)) float32 array.

    Missing requested fields raise; extra fields in the file are ignored.
    """
    with open(path, "rb") as f:
        header = _parse_header(f)
        names = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get("COUNT", " ".join("1" * len(names))).split()]
        n_points = int(header["POINTS"])
        data_kind = header["DATA"].split()[0]

        dtype_fields = []
        for name, size, typ, count in zip(names, sizes, types, counts):
            base = _NUMPY_TYPES[(typ, size)]
            if count == 1:
                dtype_fields.append((name, base))
            else:
                dtype_fields.append((name, base, (count,)))
        dtype = np.dtype(dtype_fields)

        if data_kind == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n_points, ndmin=2)
            idx = [names.index(fname) for fname in fields]
            return raw[:, idx].astype(np.float32)
        elif data_kind == "binary":
            buf = f.read(dtype.itemsize * n_points)
            arr = np.frombuffer(buf, dtype=dtype, count=n_points)
        elif data_kind == "binary_compressed":
            comp_len, uncomp_len = np.frombuffer(f.read(8), dtype=np.uint32)
            payload = f.read(int(comp_len))
            decompressed = lzf_decompress_py(payload, int(uncomp_len))
            # compressed PCD stores each field contiguously (SoA)
            arr = np.empty(n_points, dtype=dtype)
            offset = 0
            for name, size, typ, count in zip(names, sizes, types, counts):
                base = _NUMPY_TYPES[(typ, size)]
                nbytes = size * count * n_points
                col = np.frombuffer(decompressed[offset:offset + nbytes], dtype=base)
                if count > 1:
                    col = col.reshape(n_points, count)
                arr[name] = col
                offset += nbytes
        else:
            raise ValueError(f"Unsupported PCD DATA kind: {data_kind}")

    out = np.empty((n_points, len(fields)), dtype=np.float32)
    for j, fname in enumerate(fields):
        if fname not in names:
            raise KeyError(f"PCD file {path} has no field '{fname}' (has {names})")
        col = arr[fname]
        out[:, j] = col if col.ndim == 1 else col[:, 0]
    return out


def write_pcd(path: str, points: np.ndarray, data_kind: str = "binary") -> None:
    """Write an (N, 3) array as a PCD v0.7 file (``ascii`` or ``binary``)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        "FIELDS x y z\n"
        "SIZE 4 4 4\n"
        "TYPE F F F\n"
        "COUNT 1 1 1\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {data_kind}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if data_kind == "ascii":
            np.savetxt(f, points, fmt="%.6f")
        elif data_kind == "binary":
            f.write(np.ascontiguousarray(points).tobytes())
        else:
            raise ValueError(f"Unsupported write kind: {data_kind}")
