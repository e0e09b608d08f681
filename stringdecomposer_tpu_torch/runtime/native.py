"""ctypes loader for the native host runtime (libsdnative.so) with pure
NumPy/Python fallbacks; the port's copy of the JAX package's
runtime/native.py.

The library is one translation unit (runtime/native/sdnative.cpp), built
with g++ the first time it is requested (sub-second) into
stringdecomposer_tpu_torch/build/<hash of source and flags>/, the way
runtime/build.py builds the CUDA kernels. If no compiler is available the
Python fallbacks keep the pipeline fully functional, just slower on huge
inputs. This is host code: nothing here runs on the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

logger = logging.getLogger("SD-TPU")

_SOURCE = Path(__file__).resolve().parent / "native" / "sdnative.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
_lib = None
_tried = False


def library_path() -> Path:
    """Where the build of this exact source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return _BUILD_DIR / h.hexdigest()[:16] / "libsdnative.so"


def _build(out: Path) -> None:
    """Compile under a temporary name and rename into place, so concurrent
    first uses never load a half-written file."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(_SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_native(build: bool = True):
    """Returns the ctypes library or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not path.exists() and build:
        try:
            _build(path)
        except Exception as e:  # pragma: no cover - toolchain-dependent
            logger.info("native runtime unavailable (build failed: %s)", e)
            return None
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    lib.sd_encode_validate.restype = ctypes.c_int64
    lib.sd_encode_validate.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int8),
    ]
    lib.sd_homo_compress.restype = ctypes.c_int64
    lib.sd_homo_compress.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_int64, ctypes.POINTER(ctypes.c_int8),
    ]
    lib.sd_postprocess.restype = ctypes.c_int64
    lib.sd_postprocess.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.sd_postprocess_stream.restype = ctypes.c_int64
    lib.sd_postprocess_stream.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sd_format_raw.restype = ctypes.c_int64
    lib.sd_format_raw.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    if hasattr(lib, "sd_format_final"):
        p_i32 = ctypes.POINTER(ctypes.c_int32)
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        p_f64 = ctypes.POINTER(ctypes.c_double)
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.sd_format_final.restype = ctypes.c_int64
        lib.sd_format_final.argtypes = [
            ctypes.c_int64,                      # n
            ctypes.c_char_p, ctypes.c_int64,     # read_name
            ctypes.c_char_p, p_i64,              # names
            ctypes.c_char_p, p_i64,              # uniq names
            ctypes.c_int64,                      # n_uniq
            p_i32, p_i32,                        # best_idx, best_upos
            p_i64, p_i64,                        # starts, ends
            p_f64,                               # score
            p_i32, p_f64,                        # sb
            p_i32, p_f64,                        # hb
            p_i32, p_f64,                        # hs
            p_u8,                                # reliable
            p_f64,                               # alt or None
            ctypes.c_double,                     # identity_th
            ctypes.c_char_p, ctypes.c_int64,     # out
            ctypes.c_char_p, ctypes.c_int64, p_i64,  # alt_out
        ]
    _lib = lib
    return _lib


def _names_table(names: list[str]) -> tuple[bytes, np.ndarray]:
    encoded = [n.encode() for n in names]
    offs = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offs[1:])
    return b"".join(encoded), offs


def format_final_native(
    read_name: str,
    names: list[str],
    uniq_names: list[str],
    best_idx: np.ndarray,
    best_upos: np.ndarray,
    starts: np.ndarray,
    ends: np.ndarray,
    score: np.ndarray,
    sb_idx: np.ndarray,
    sb_score: np.ndarray,
    hb_idx: np.ndarray,
    hb_score: np.ndarray,
    hs_idx: np.ndarray,
    hs_score: np.ndarray,
    reliable: np.ndarray,
    alt: np.ndarray | None,
    identity_th: float,
) -> tuple[bytes, bytes] | None:
    """(final_bytes, alt_bytes) for one read chunk, or None if the native
    library is unavailable (callers fall back to the Python emitter)."""
    lib = load_native()
    if lib is None or not hasattr(lib, "sd_format_final"):
        return None
    n = len(starts)
    names_buf, names_off = _names_table(names)
    uniq_buf, uniq_off = _names_table(uniq_names)
    rn = read_name.encode()
    max_nm = max(4, max((uniq_off[i + 1] - uniq_off[i] for i in range(len(uniq_names))), default=4))
    row = len(rn) + 4 * int(max_nm) + 256
    alt_row = len(rn) + int(max_nm) + 256
    cap = n * row + 64
    alt_cap = (n * len(uniq_names) * alt_row + 64) if alt is not None else 64
    # np.empty, not ctypes.create_string_buffer: the latter zero-fills the
    # whole buffer (hundreds of MB per 20 Mbp run, measurably slow)
    out = np.empty(cap, dtype=np.uint8)
    alt_out = np.empty(alt_cap, dtype=np.uint8)
    aw = ctypes.c_int64(0)

    def f64(a):
        return np.ascontiguousarray(a, dtype=np.float64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_double))

    def i32(a):
        return np.ascontiguousarray(a, dtype=np.int32).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32))

    def i64(a):
        return np.ascontiguousarray(a, dtype=np.int64).ctypes.data_as(
            ctypes.POINTER(ctypes.c_int64))

    # keep contiguous temporaries alive across the call
    arrs = [np.ascontiguousarray(a, dtype=d) for a, d in (
        (best_idx, np.int32), (best_upos, np.int32), (starts, np.int64),
        (ends, np.int64), (score, np.float64), (sb_idx, np.int32),
        (sb_score, np.float64), (hb_idx, np.int32), (hb_score, np.float64),
        (hs_idx, np.int32), (hs_score, np.float64),
    )]
    rel = np.ascontiguousarray(reliable, dtype=np.uint8)
    alt_c = np.ascontiguousarray(alt, dtype=np.float64) if alt is not None else None
    w = lib.sd_format_final(
        n, rn, len(rn),
        names_buf, names_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        uniq_buf, uniq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(uniq_names),
        i32(arrs[0]), i32(arrs[1]), i64(arrs[2]), i64(arrs[3]), f64(arrs[4]),
        i32(arrs[5]), f64(arrs[6]), i32(arrs[7]), f64(arrs[8]),
        i32(arrs[9]), f64(arrs[10]),
        rel.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        alt_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)) if alt_c is not None else None,
        float(identity_th),
        out.ctypes.data_as(ctypes.c_char_p), cap,
        alt_out.ctypes.data_as(ctypes.c_char_p), alt_cap, ctypes.byref(aw),
    )
    if w < 0:
        return None
    return out[:w].tobytes(), alt_out[:aw.value].tobytes()


def _as_i32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def postprocess_native(blocks: np.ndarray) -> np.ndarray | None:
    """blocks: [n, 4] int32 -> bool keep mask, or None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    blocks = np.ascontiguousarray(blocks, dtype=np.int32)
    keep = np.zeros(len(blocks), dtype=np.uint8)
    lib.sd_postprocess(
        _as_i32_ptr(blocks), len(blocks),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return keep.astype(bool)


def postprocess_stream_native(
    blocks: np.ndarray, bounds: np.ndarray, final: bool, landing: bool
) -> tuple[np.ndarray, np.ndarray, int, bool] | None:
    """One push of ops/records.DedupStream: blocks [n, 4] int32 (the held
    blocks, then a run of windows ending at `bounds`) -> (indices of the
    emitted blocks, emitted count at each window's end, index of the first
    block still held, landing flag), or None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    blocks = np.ascontiguousarray(blocks, dtype=np.int32)
    bounds = np.ascontiguousarray(bounds, dtype=np.int64)
    emit = np.empty(len(blocks), dtype=np.int64)
    cuts = np.empty(len(bounds), dtype=np.int64)
    land = ctypes.c_int32(int(landing))
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    held = lib.sd_postprocess_stream(
        _as_i32_ptr(blocks), bounds.ctypes.data_as(p_i64), len(bounds), int(final),
        ctypes.byref(land), emit.ctypes.data_as(p_i64), cuts.ctypes.data_as(p_i64),
    )
    return emit[: cuts[-1] if len(cuts) else 0], cuts, int(held), bool(land.value)


class NameTable:
    """Monomer names as the native formatters take them: the encoded names
    concatenated, with [M + 1] offsets. Build it once for many calls."""

    def __init__(self, names: list[str]):
        self.buf, self.offs = _names_table(names)
        self.max_len = int(np.diff(self.offs).max(initial=0))


def format_raw_native(
    blocks: np.ndarray, read_name: str, monomer_names: list[str] | NameTable,
    prev_end: int = 0,
) -> bytes | None:
    """Raw TSV bytes for a read's postprocessed [n,4] int32 blocks, or a
    chunk of them: `prev_end` is the last end of the read's chunk before,
    as in report.format_raw_rows."""
    lib = load_native()
    if lib is None:
        return None
    blocks = np.ascontiguousarray(blocks, dtype=np.int32)
    table = monomer_names if isinstance(monomer_names, NameTable) else NameTable(monomer_names)
    rn = read_name.encode()
    cap = len(blocks) * (len(rn) + table.max_len + 96) + 64
    out = np.empty(cap, dtype=np.uint8)  # not zero-filled, unlike a ctypes buffer
    w = lib.sd_format_raw(
        _as_i32_ptr(blocks), len(blocks),
        rn, len(rn),
        table.buf, table.offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(prev_end), out.ctypes.data, cap,
    )
    if w < 0:
        return None
    return out[:w].tobytes()


def homo_compress_native(codes: np.ndarray) -> np.ndarray | None:
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    out = np.empty_like(codes)
    p = ctypes.POINTER(ctypes.c_int8)
    m = lib.sd_homo_compress(codes.ctypes.data_as(p), len(codes), out.ctypes.data_as(p))
    return out[:m]
