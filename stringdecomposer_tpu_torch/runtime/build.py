"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles each source into an object, all at once in parallel, and
links them into one shared library with a plain C interface, keyed by a
hash of the sources, headers and flags, under stringdecomposer_tpu_torch/build/;
ctypes loads it. No PyTorch headers are involved, so a build takes seconds.
Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` raises on a non-zero code.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# name -> (restype, argtypes); every pointer and the stream are c_void_p
_SIGNATURES = {
    "sd_chain_dp": (_I, [_I, _I, _P, _P, _LL, _P, _LL, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_chain_dp_lanes": (_I, [_I, _P, _P, _LL, _P, _LL, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_chain_dp_cluster": (_I, [_I, _I, _I, _P, _P, _LL, _P, _LL, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_chain_dp_cluster_occupancy": (_I, [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]),
    "sd_chain_dp_tiled": (_I, [_I, _I, _I, _P, _P, _LL, _P, _LL, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_chain_dp_cluster_tiled": (_I, [_I, _I, _I, _I, _I, _P, _P, _LL, _P, _LL, _P, _P, _P,
                                       _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_chain_dp_cluster_tiled_occupancy": (_I, [_I, _I, _I, _I, _I, _I, _I, _I,
                                                 ctypes.POINTER(_I)]),
    "sd_chain_dp_grid": (_I, [_I, _I, _I, _I, _P, _P, _LL, _P, _LL, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "sd_chain_dp_grid_occupancy": (_I, [_I, _I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)]),
    "sd_chain_dp_grid_tiled": (_I, [_I, _I, _I, _I, _I, _I, _I, _P, _P, _LL, _P, _LL, _P, _P,
                                    _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "sd_chain_dp_grid_tiled_occupancy": (_I, [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                              ctypes.POINTER(_I)]),
    "sd_chain_dp_ablate": (_I, [_I, _I, _I, _I, _P, _P, _LL, _P, _LL, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_block_walk": (_I, [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "sd_int16_probe": (_I, [_P, _P, _I, _I, _P]),
    "sd_hw_distance": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_hw_occupancy": (_I, [_I, _I, ctypes.POINTER(_I)]),
    "sd_nw_identity": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "sd_nw_identity_cross": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "sd_banded_column": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_banded_myers": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "sd_semi_wide": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_semi_wide_occupancy": (_I, [_I, ctypes.POINTER(_I)]),
    "sd_banded_warp": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "sd_myers_warp": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "sd_semi_warp": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "sd_semi_warp_occupancy": (_I, [_I, ctypes.POINTER(_I)]),
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
    for src in sorted(CSRC.glob("*.cu*")):  # sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libsdtorch.so"


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists:
    one nvcc per source, all started together (so the build time stays
    that of the slowest source as sources are added), then one link. The
    library is written under a temporary name and renamed into place, so
    concurrent first uses never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as work:
        objs = [os.path.join(work, src.stem + ".o") for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for obj, src in zip(objs, _sources())]
        tmp = os.path.join(work, "lib.so")
        cmds.append([nvcc, "-shared", "-o", tmp, *objs])
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds[:-1]]
        log = [" ".join(c) + "\n" + p.communicate()[0] for c, p in zip(cmds, procs)]
        codes = [p.returncode for p in procs]
        if not any(codes):
            link = subprocess.run(cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            log.append(" ".join(cmds[-1]) + "\n" + link.stdout)
            codes.append(link.returncode)
        (out.parent / "build.log").write_text("".join(log))
        if any(codes):
            failed = [f"({code}) {text[-4000:]}" for text, code in zip(log, codes) if code]
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
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


def count_launch(wrapper, counter: str = "launches") -> None:
    """Add one to a kernel wrapper's launch counter (`launches`, or the
    named counter of a wrapper that launches several kernels)."""
    with _lock:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().sd_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(x) -> int:
    """PyTorch's current stream on the tensor's device, as a raw handle."""
    import torch

    return torch.cuda.current_stream(x.device).cuda_stream
