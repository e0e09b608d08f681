"""Carry the system's state from the JAX package's NumPy form to device tensors.

The system has no trained network. Its state is the monomer set (padded
int8 codes and lengths in DP order, from io/fasta.pad_monomers; encoded
codes in the interleaved finishing order, raw and homopolymer-compressed)
and the reliability coefficients (models/ont_logreg_model.txt, read by
models/reliability.load_coefficients). Both packages build these arrays with
the same JAX-free code, so a test can hand one set to both.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class DeviceState:
    mono: torch.Tensor  # [M_dp, L] int8, PAD_CODE-padded, DP order
    mono_lens: torch.Tensor  # [M_dp] int32
    t_raw: torch.Tensor  # [M_fin, Lt] int8 finishing-order codes, 0-padded
    tl_raw: torch.Tensor  # [M_fin] int32
    t_homo: torch.Tensor  # [M_fin, Lh] int8 homopolymer-compressed codes
    tl_homo: torch.Tensor  # [M_fin] int32
    coef: np.ndarray  # [3] float64 reliability coefficients (host-side classify)


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
    from stringdecomposer_tpu.io.fasta import encode, pad_monomers
    from stringdecomposer_tpu.models.reliability import load_coefficients

    if monomers_dp:
        L = max(len(m.seq) for m in monomers_dp)
        mono, mono_lens = pad_monomers(monomers_dp, pad_to=(L + 7) // 8 * 8)
    else:
        mono, mono_lens = np.zeros((0, 8), np.int8), np.zeros(0, np.int32)
    from .finishing import _homo_codes

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
