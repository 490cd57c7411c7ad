"""ctypes bindings for the native host runtime (libtsa.so)."""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_HERE = pathlib.Path(__file__).parent
# built from tsalib.cpp at first use (make rebuilds it when the source
# is newer); build/ is not committed
_LIB_PATH = _HERE / "build" / "libtsa.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            subprocess.run(["make", "-C", str(_HERE)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            if not _LIB_PATH.exists():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            return None
        lib.tsa_walk.restype = ctypes.c_int64
        lib.tsa_walk.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.tsa_render.restype = None
        lib.tsa_render.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        lib.tsa_fasta_scan.restype = ctypes.c_int
        lib.tsa_fasta_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.tsa_fasta_parse.restype = ctypes.c_int
        lib.tsa_fasta_parse.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.tsa_replay_rle_batch.restype = ctypes.c_int
        lib.tsa_replay_rle_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.tsa_walk_batch.restype = ctypes.c_int
        lib.tsa_walk_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def walk(dirs, m, n, t0, layout):
    """Native traceback walk. Returns list of (t', pi, pj) steps in
    end->start order, or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    dirs = np.ascontiguousarray(dirs) if dirs.strides[-1] != 1 else dirs
    if dirs.dtype != np.uint8:
        dirs = dirs.astype(np.uint8)
    cap = int(m + n + 2)
    out_t = np.empty(cap, np.int32)
    out_pi = np.empty(cap, np.int64)
    out_pj = np.empty(cap, np.int64)
    k = lib.tsa_walk(
        dirs.ctypes.data, dirs.strides[0], dirs.strides[-1] if dirs.ndim == 2
        else dirs.strides[1],
        int(m), int(n), int(t0), 1 if layout == "skew" else 0,
        out_t.ctypes.data, out_pi.ctypes.data, out_pj.ctypes.data)
    return list(zip(out_t[:k].tolist(), out_pi[:k].tolist(),
                    out_pj[:k].tolist()))


def walk_batch(dirs, ms, ns, t0s, layout, mode):
    """Thread-parallel traceback of every pair sharing one direction
    array.

    ``dirs``: (B, rows, cols) uint8, pair-major — the XLA wavefront's
    skew layout (B, m+n+1, n+1) or a rect layout. ``mode``: "parity" |
    "full". Returns (tt, ii, jj, lens) with chains at [r, :lens[r]], or
    None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    dirs = np.ascontiguousarray(dirs)
    if dirs.dtype != np.uint8:
        dirs = dirs.astype(np.uint8)
    stride_r, stride_d, stride_j = dirs.strides
    B = dirs.shape[0]
    ms = np.ascontiguousarray(ms, np.int64)
    ns = np.ascontiguousarray(ns, np.int64)
    t0s = np.ascontiguousarray(t0s, np.int32)
    cap = int(ms.max(initial=0) + ns.max(initial=0) + 2)
    out_t = np.empty((B, cap), np.int32)
    out_i = np.empty((B, cap), np.int64)
    out_j = np.empty((B, cap), np.int64)
    out_len = np.empty((B,), np.int64)
    lib.tsa_walk_batch(
        dirs.ctypes.data, stride_r, stride_d, stride_j,
        ms.ctypes.data, ns.ctypes.data, t0s.ctypes.data, B,
        1 if layout == "skew" else 0, 1 if mode == "full" else 0,
        cap, out_t.ctypes.data, out_i.ctypes.data, out_j.ctypes.data,
        out_len.ctypes.data)
    return out_t, out_i, out_j, out_len


def replay_rle(entries, la, lb, t0s, mode, offsets=None, chunk=None):
    """Thread-parallel replay of the fused path's RLE walk entries
    ((B, Rn) uint16, entry = op | runlen << 2). Mirrors
    ops/device_walk.py replay_ops exactly (B1/B2 quirks, offsets, full
    mode's forced edge runs). Returns (tt, ii, jj, lens) or None when
    the native library is unavailable; raises RuntimeError if a stream
    ends before a DP edge (corrupt entries)."""
    lib = _load()
    if lib is None:
        return None
    entries = np.ascontiguousarray(entries, np.uint16)
    B, Rn = entries.shape
    la = np.ascontiguousarray(la, np.int64)
    lb = np.ascontiguousarray(lb, np.int64)
    t0s = np.ascontiguousarray(t0s, np.int32)
    if offsets is not None and chunk is not None:
        offs = np.asarray([offsets[chunk[r]] for r in range(B)],
                          np.int64)
        ida = np.ascontiguousarray(offs[:, 0])
        idb = np.ascontiguousarray(offs[:, 1])
        ida_p, idb_p = ida.ctypes.data, idb.ctypes.data
    else:
        ida_p = idb_p = None
    cap = int(la.max(initial=0) + lb.max(initial=0) + 2)
    if mode == "full":
        cap *= 2
    out_t = np.empty((B, cap), np.int32)
    out_i = np.empty((B, cap), np.int64)
    out_j = np.empty((B, cap), np.int64)
    out_len = np.empty((B,), np.int64)
    lib.tsa_replay_rle_batch(
        entries.ctypes.data, Rn, la.ctypes.data, lb.ctypes.data,
        t0s.ctypes.data, ida_p, idb_p, B,
        1 if mode == "full" else 0, cap, out_t.ctypes.data,
        out_i.ctypes.data, out_j.ctypes.data, out_len.ctypes.data)
    if (out_len < 0).any():
        bad = np.nonzero(out_len < 0)[0]
        raise RuntimeError(
            f"RLE walk stream ended before a DP edge for pairs "
            f"{bad[:8].tolist()} (corrupt entries)")
    return out_t, out_i, out_j, out_len


def render(a_enc, b_enc, tt, ii, jj):
    """Native print_seq renderer. Returns (row_a, row_b) strings or None."""
    lib = _load()
    if lib is None:
        return None
    tt = np.ascontiguousarray(tt, np.int32)
    ii = np.ascontiguousarray(ii, np.int64)
    jj = np.ascontiguousarray(jj, np.int64)
    a_enc = np.ascontiguousarray(a_enc, np.uint8)
    b_enc = np.ascontiguousarray(b_enc, np.uint8)
    L = len(tt)
    row_a = np.empty(L, np.uint8)
    row_b = np.empty(L, np.uint8)
    lib.tsa_render(a_enc.ctypes.data, b_enc.ctypes.data, tt.ctypes.data,
                   ii.ctypes.data, jj.ctypes.data, L,
                   row_a.ctypes.data, row_b.ctypes.data)
    return row_a.tobytes().decode("ascii"), row_b.tobytes().decode("ascii")


def fasta_parse(data: bytes):
    """Native FASTA parse. Returns (names, sequences) or None."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    nrec = ctypes.c_int64(0)
    nbytes = ctypes.c_int64(0)
    lib.tsa_fasta_scan(buf.ctypes.data, buf.size,
                       ctypes.byref(nrec), ctypes.byref(nbytes))
    nrec, nbytes = nrec.value, nbytes.value
    if nrec == 0:
        return [], []
    seq = np.empty(nbytes, np.uint8)
    offsets = np.empty(nrec + 1, np.int64)
    spans = np.empty(2 * nrec, np.int64)
    lib.tsa_fasta_parse(buf.ctypes.data, buf.size, seq.ctypes.data,
                        offsets.ctypes.data, spans.ctypes.data)
    names = [data[spans[2 * k]: spans[2 * k] + spans[2 * k + 1]]
             .decode("ascii") for k in range(nrec)]
    seqs = [seq[offsets[k]: offsets[k + 1]].tobytes().decode("ascii")
            for k in range(nrec)]
    return names, seqs
