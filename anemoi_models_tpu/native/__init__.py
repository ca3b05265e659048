"""Native (C++) graph-build kernels, compiled on first use and loaded via
ctypes. Every entry point has a NumPy fallback in ``graphs/``; ``available()``
reports whether the native path is usable.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

LOGGER = logging.getLogger(__name__)

__all__ = [
    "available",
    "sort_edges_csr",
    "dense_tables",
    "fill_bucket_tables",
    "blosclz_decompress",
    "lz4_decompress",
    "sort_positions_by_row",
    "sort_positions_by_row_masked",
    "subdivide",
]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_and_load() -> Optional[ctypes.CDLL]:
    import hashlib

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "graph_native.cpp")
    cache_dir = os.environ.get(
        "ANEMOI_NATIVE_CACHE", os.path.join(tempfile.gettempdir(), "anemoi_native")
    )
    os.makedirs(cache_dir, exist_ok=True)
    # content-keyed cache: mtime comparisons mislead when clones/worktrees
    # at different commits share the cache (a stale .so would load but lack
    # newer symbols)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(cache_dir, f"graph_native_{digest}.so")
    try:
        if not os.path.exists(so_path):
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", src, "-o", so_path]
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        lib = ctypes.CDLL(so_path)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.sort_edges_csr.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i64p, i64p]
        lib.sort_edges_csr.restype = None
        lib.dense_tables.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32p, i32p, u8p]
        lib.dense_tables.restype = None
        lib.max_in_degree.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32]
        lib.max_in_degree.restype = ctypes.c_int32
        lib.subdivide.argtypes = [f64p, ctypes.c_int64, i64p, ctypes.c_int64, f64p, i64p]
        lib.subdivide.restype = ctypes.c_int64
        lib.sort_positions_by_row.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p]
        lib.sort_positions_by_row.restype = ctypes.c_int64
        lib.sort_positions_by_row_masked.argtypes = [
            i32p, u8p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p,
        ]
        lib.sort_positions_by_row_masked.restype = ctypes.c_int64
        lib.fill_bucket_tables.argtypes = [
            i32p, i64p, i32p, ctypes.c_int64, ctypes.c_int32, i32p, i32p, u8p,
        ]
        lib.fill_bucket_tables.restype = None
        lib.lz4_decompress_block.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
        ]
        lib.lz4_decompress_block.restype = ctypes.c_int64
        lib.blosclz_decompress_block.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
        ]
        lib.blosclz_decompress_block.restype = ctypes.c_int64
        return lib
    except Exception as exc:  # compiler/loader/symbol failure: numpy fallback
        LOGGER.warning("native graph kernels unavailable (%s); using numpy fallbacks", exc)
        return None


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _build_and_load()
    return _LIB


def available() -> bool:
    return _lib() is not None


def sort_edges_csr(edge_index: np.ndarray, num_src: int, num_dst: int):
    """(perm, dst_ptr) sorting edges by (dst, src); None if native unavailable."""
    lib = _lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(edge_index[0], dtype=np.int32)
    dst = np.ascontiguousarray(edge_index[1], dtype=np.int32)
    e = src.shape[0]
    perm = np.empty(e, dtype=np.int64)
    dst_ptr = np.empty(num_dst + 1, dtype=np.int64)
    lib.sort_edges_csr(src, dst, e, num_src, num_dst, perm, dst_ptr)
    return perm, dst_ptr


def dense_tables(edge_index_sorted: np.ndarray, num_dst: int, pad_to_multiple: int = 1):
    """(edge_ids, src_ids, mask) dense tables; None if native unavailable."""
    lib = _lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(edge_index_sorted[0], dtype=np.int32)
    dst = np.ascontiguousarray(edge_index_sorted[1], dtype=np.int32)
    e = src.shape[0]
    max_deg = int(lib.max_in_degree(dst, e, num_dst))
    if pad_to_multiple > 1 and max_deg % pad_to_multiple:
        max_deg += pad_to_multiple - max_deg % pad_to_multiple
    max_deg = max(max_deg, 1)
    edge_ids = np.empty((num_dst, max_deg), dtype=np.int32)
    src_ids = np.empty((num_dst, max_deg), dtype=np.int32)
    mask = np.empty((num_dst, max_deg), dtype=np.uint8)
    lib.dense_tables(src, dst, e, num_dst, max_deg, edge_ids, src_ids, mask)
    return edge_ids, src_ids, mask.astype(bool)


def sort_positions_by_row(ids: np.ndarray, num_rows: int):
    """(counts, rows_sorted, pos_sorted) — live gather positions counting-
    sorted by the row they read (stable); None if native unavailable."""
    lib = _lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    counts = np.empty(num_rows, dtype=np.int64)
    rows_sorted = np.empty(max(len(ids), 1), dtype=np.int64)
    pos_sorted = np.empty(max(len(ids), 1), dtype=np.int64)
    n = int(lib.sort_positions_by_row(ids, len(ids), num_rows, counts, rows_sorted, pos_sorted))
    return counts, rows_sorted[:n], pos_sorted[:n]


def sort_positions_by_row_masked(ids: np.ndarray, mask: np.ndarray, num_rows: int):
    """As :func:`sort_positions_by_row`, but over an int32 id table with a
    separate mask (the forward bucket layout) — avoids materializing the
    (P,) int64 where(mask, ids, -1) vector. None if native unavailable."""
    lib = _lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int32).ravel()
    mask = np.ascontiguousarray(mask).ravel()
    mask = mask.view(np.uint8) if mask.dtype == np.bool_ else mask.astype(np.uint8)
    counts = np.empty(num_rows, dtype=np.int64)
    rows_sorted = np.empty(max(len(ids), 1), dtype=np.int64)
    pos_sorted = np.empty(max(len(ids), 1), dtype=np.int64)
    n = int(lib.sort_positions_by_row_masked(
        ids, mask, len(ids), num_rows, counts, rows_sorted, pos_sorted
    ))
    return counts, rows_sorted[:n], pos_sorted[:n]


def fill_bucket_tables(
    src_sorted: np.ndarray, starts: np.ndarray, node_ids: np.ndarray, cap: int
):
    """(edge_ids, src_ids, mask) padded tables for one degree bucket;
    None if native unavailable."""
    lib = _lib()
    if lib is None:
        return None
    src_sorted = np.ascontiguousarray(src_sorted, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    node_ids = np.ascontiguousarray(node_ids, dtype=np.int32)
    nb = len(node_ids)
    edge_ids = np.empty((nb, cap), dtype=np.int32)
    src_ids = np.empty((nb, cap), dtype=np.int32)
    mask = np.empty((nb, cap), dtype=np.uint8)
    lib.fill_bucket_tables(src_sorted, starts, node_ids, nb, cap, edge_ids, src_ids, mask)
    return edge_ids, src_ids, mask.astype(bool)


def subdivide(verts: np.ndarray, faces: np.ndarray):
    """One icosphere subdivision; None if native unavailable."""
    lib = _lib()
    if lib is None:
        return None
    verts = np.ascontiguousarray(verts, dtype=np.float64)
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    nv, nf = verts.shape[0], faces.shape[0]
    # Euler: a closed triangulated sphere has 3/2 edges per face -> midpoints
    new_verts = np.empty((nv + (3 * nf) // 2, 3), dtype=np.float64)
    new_faces = np.empty((4 * nf, 3), dtype=np.int64)
    count = int(lib.subdivide(verts, nv, faces, nf, new_verts, new_faces))
    return new_verts[:count], new_faces


def _lz4_decompress_py(src: bytes, dst_len: int) -> bytes:
    """Pure-Python LZ4 block decoder — correctness fallback for
    :func:`lz4_decompress_block` when the native library is unavailable.
    Same format handling (token nibbles, 255-continuations, overlapping
    match copies); raises ValueError on malformed input."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated literal length")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise ValueError("lz4: truncated literals")
        out += src[i : i + lit]
        i += lit
        if i >= n:
            break  # last sequence carries literals only
        if i + 2 > n:
            raise ValueError("lz4: truncated offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError("lz4: bad match offset")
        mlen = (token & 15) + 4
        if (token & 15) == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated match length")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        for _ in range(mlen):  # byte-wise: overlapping matches are defined
            out.append(out[-offset])
    if len(out) != dst_len:
        raise ValueError(f"lz4: decoded {len(out)} bytes, expected {dst_len}")
    return bytes(out)


def lz4_decompress(src: bytes, dst_len: int) -> bytes:
    """LZ4 block decompression (native if available, Python otherwise)."""
    lib = _lib()
    if lib is None:
        return _lz4_decompress_py(src, dst_len)
    sbuf = np.frombuffer(src, dtype=np.uint8)
    dbuf = np.empty(dst_len, dtype=np.uint8)
    got = lib.lz4_decompress_block(
        np.ascontiguousarray(sbuf), sbuf.shape[0], dbuf, dst_len
    )
    if got != dst_len:
        raise ValueError(f"lz4: decoded {got} bytes, expected {dst_len}")
    return dbuf.tobytes()


def _blosclz_decompress_py(src: bytes, dst_len: int) -> bytes:
    """Pure-Python BloscLZ block decoder — correctness twin of the native
    ``blosclz_decompress_block`` (format notes there). Raises ValueError on
    malformed input."""
    out = bytearray()
    i, n = 0, len(src)
    if n == 0:
        if dst_len:
            raise ValueError("blosclz: empty stream")
        return b""
    ctrl = src[i] & 31
    i += 1
    more = True
    while more:
        if ctrl >= 32:
            ln = (ctrl >> 5) - 1
            ofs = (ctrl & 31) << 8
            if ln == 6:
                while True:
                    if i >= n:
                        raise ValueError("blosclz: truncated match length")
                    ext = src[i]
                    i += 1
                    ln += ext
                    if ext != 255:
                        break
            if i >= n:
                raise ValueError("blosclz: truncated match offset")
            code = src[i]
            i += 1
            dist = ofs + code
            if code == 255 and ofs == (31 << 8):
                if i + 2 > n:
                    raise ValueError("blosclz: truncated far offset")
                dist = ((src[i] << 8) | src[i + 1]) + 8191
                i += 2
            if i < n:
                ctrl = src[i]
                i += 1
            else:
                more = False
            ln += 3
            d = dist + 1
            if d > len(out):
                raise ValueError("blosclz: match offset beyond output")
            for _ in range(ln):  # byte-wise: overlapping (RLE) matches
                out.append(out[-d])
        else:
            ln = ctrl + 1
            if i + ln > n:
                raise ValueError("blosclz: truncated literals")
            out += src[i : i + ln]
            i += ln
            if i < n:
                ctrl = src[i]
                i += 1
            else:
                more = False
    if len(out) != dst_len:
        raise ValueError(f"blosclz: decoded {len(out)} bytes, expected {dst_len}")
    return bytes(out)


def blosclz_decompress(src: bytes, dst_len: int) -> bytes:
    """BloscLZ block decompression (native if available, Python otherwise)."""
    lib = _lib()
    if lib is None:
        return _blosclz_decompress_py(src, dst_len)
    sbuf = np.frombuffer(src, dtype=np.uint8)
    dbuf = np.empty(dst_len, dtype=np.uint8)
    got = lib.blosclz_decompress_block(
        np.ascontiguousarray(sbuf), sbuf.shape[0], dbuf, dst_len
    )
    if got != dst_len:
        raise ValueError(f"blosclz: decoded {got} bytes, expected {dst_len}")
    return dbuf.tobytes()
