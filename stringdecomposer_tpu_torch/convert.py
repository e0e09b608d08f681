"""Carry the system's state from the JAX package's NumPy form to device tensors.

The system has no trained network. Its state is the monomer set (padded
int8 codes and lengths in DP order, from io/fasta.pad_monomers; encoded
codes in the interleaved finishing order, raw and homopolymer-compressed)
and the reliability coefficients (models/ont_logreg_model.txt, read by
models/reliability.load_coefficients). The port builds these arrays with
its own copies of the JAX package's host modules (io/fasta.py,
models/reliability.py), which give the same arrays, so a test can hand one
set to both.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .io.fasta import encode, pad_monomers
from .models.reliability import load_coefficients


@dataclass
class DeviceState:
    mono: torch.Tensor  # [M_dp, L] int8, PAD_CODE-padded, DP order
    mono_lens: torch.Tensor  # [M_dp] int32
    t_raw: torch.Tensor  # [M_fin, Lt] int8 finishing-order codes, 0-padded
    tl_raw: torch.Tensor  # [M_fin] int32
    t_homo: torch.Tensor  # [M_fin, Lh] int8 homopolymer-compressed codes
    tl_homo: torch.Tensor  # [M_fin] int32
    coef: np.ndarray  # [3] float64 reliability coefficients (host-side classify)


def upload(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """A NumPy array on `device` without waiting on the device. On CUDA the
    copy goes through pinned memory, non-blocking on the current stream (a
    copy from pageable memory would first wait for all the stream's queued
    work); on the CPU it is the array itself, shared."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """Start the copy of a CUDA tensor to pinned host memory on the current
    stream and return the host tensor, to be read once an event recorded
    after it (`done_event`) has completed (`wait_done`). A CPU tensor comes
    back as it is."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def done_event(device: torch.device | str):
    """A CUDA event recorded on the current stream of `device`; None on the
    CPU, where work is done when its call returns."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def wait_done(event) -> None:
    """Block the host until `event` (from done_event) has completed."""
    if event is not None:
        event.synchronize()


def pad_codes(codes: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad code arrays to [n, max_len] with 0, plus their lengths."""
    L = max(1, max((len(c) for c in codes), default=1))
    arr = np.zeros((len(codes), L), dtype=np.int8)
    lens = np.zeros(len(codes), dtype=np.int32)
    for i, c in enumerate(codes):
        arr[i, : len(c)] = c
        lens[i] = len(c)
    return arr, lens


def numpy_state(monomers_dp: list, monomers_fin: list, model_file: str | None = None):
    """The state as the JAX package builds it: (mono, mono_lens) padded to a
    multiple of 8 in DP order (pipeline.decompose_stream), the finishing
    codes raw and homopolymer-compressed (finishing.AsyncFinisher), and the
    reliability coefficients."""
    from .finishing import _homo_codes

    if monomers_dp:
        L = max(len(m.seq) for m in monomers_dp)
        mono, mono_lens = pad_monomers(monomers_dp, pad_to=(L + 7) // 8 * 8)
    else:
        mono, mono_lens = np.zeros((0, 8), np.int8), np.zeros(0, np.int32)
    fin = [encode(m.seq) for m in monomers_fin]
    return mono, mono_lens, fin, [_homo_codes(c) for c in fin], load_coefficients(model_file)


def state_from_numpy(
    mono: np.ndarray,
    mono_lens: np.ndarray,
    fin_codes: list[np.ndarray],
    homo_codes: list[np.ndarray],
    coef: np.ndarray,
    device: torch.device | str,
) -> DeviceState:
    """NumPy state of the JAX package -> the port's tensors on `device`."""

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    t_raw, tl_raw = pad_codes(fin_codes)
    t_homo, tl_homo = pad_codes(homo_codes)
    return DeviceState(
        mono=dev(mono, torch.int8), mono_lens=dev(mono_lens, torch.int32),
        t_raw=dev(t_raw, torch.int8), tl_raw=dev(tl_raw, torch.int32),
        t_homo=dev(t_homo, torch.int8), tl_homo=dev(tl_homo, torch.int32),
        coef=np.asarray(coef, dtype=np.float64),
    )
