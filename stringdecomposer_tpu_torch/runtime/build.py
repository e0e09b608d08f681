"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles every source into one shared library with a plain C
interface, keyed by a hash of the sources and flags, under
stringdecomposer_tpu_torch/build/; ctypes loads it. No PyTorch headers are
involved, so a build takes seconds. Each C entry point launches on the
stream it is given and returns cudaGetLastError(); `check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# name -> (restype, argtypes); every pointer and the stream are c_void_p
_SIGNATURES = {
    "sd_chain_dp": (_I, [_P, _P, _LL, _P, _LL, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_chain_dp_large": (_I, [_P, _P, _LL, _P, _LL, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_block_walk": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "sd_hw_distance": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "sd_nw_identity": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "sd_banded_column": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_banded_myers": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_semi_ends": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_error_string": (ctypes.c_char_p, [_I]),
}

_lib: ctypes.CDLL | None = None
# the finisher's worker threads (-t > 1) launch kernels too: the first load
# and the launch counters are shared between them
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libsdtorch.so"


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists.
    The library is written under a temporary name and renamed into place,
    so concurrent first uses never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _lib = lib
    return _lib


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `launches` counter."""
    with _lock:
        wrapper.launches += 1


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().sd_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(x) -> int:
    """PyTorch's current stream on the tensor's device, as a raw handle."""
    import torch

    return torch.cuda.current_stream(x.device).cuda_stream
