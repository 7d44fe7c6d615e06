"""Hamming distance matrix: CUDA kernel and plain version.

Replaces the TPU kernel `ya_vo_tpu/features/pallas_hamming.py:_hamming_kernel`
(launched by `hamming_matrix_pallas`). The kernel is `csrc/hamming.cu`: the
bits go to the int8 tensor cores as 0/1 bytes and each distance is
popc(a) + popc(b) - 2 <a, b>, exact. A CPU tensor takes
`hamming_matrix_plain`; a CUDA tensor launches the kernel or raises.
Descriptors are [K, W] int32 tensors holding uint32 bit patterns, W at most
MAX_WORDS (512 bits).
"""

from __future__ import annotations

import torch

from ya_vo_tpu_torch import _build

MAX_WORDS = 16   # the kernel's longest descriptor, in 32-bit words


def unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """[K, W] packed bits -> [K, 32*W] float32 in {-1, +1}."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1   # arithmetic shift keeps bit b
    return (bits.reshape(desc.shape[0], -1) * 2 - 1).to(torch.float32)


def hamming_matrix_plain(desc1: torch.Tensor,
                         desc2: torch.Tensor) -> torch.Tensor:
    """[K1, K2] int32 distances as (n_bits - <a, b>) / 2 over +-1 vectors
    (the Pallas kernel's formulation; exact in float32 up to 2^24 bits)."""
    n_bits = desc1.shape[1] * 32
    dots = unpack_pm1(desc1) @ unpack_pm1(desc2).T
    return ((n_bits - dots) * 0.5).to(torch.int32)


def hamming_matrix(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """[K1, W] x [K2, W] -> [K1, K2] int32 Hamming distances."""
    if desc1.device.type == "cpu":
        return hamming_matrix_plain(desc1, desc2)
    _build.check_cuda("hamming desc1", desc1, torch.int32, (None, None))
    _build.check_cuda("hamming desc2", desc2, torch.int32,
                      (None, desc1.shape[1]))
    K1, Wn = desc1.shape
    K2 = desc2.shape[0]
    if not 1 <= Wn <= MAX_WORDS:
        raise ValueError(f"hamming: {Wn} words a descriptor, the kernel "
                         f"takes 1 to {MAX_WORDS}")
    out = torch.empty((K1, K2), dtype=torch.int32, device=desc1.device)
    _build.launch("hamming", desc1.data_ptr(), desc2.data_ptr(),
                  out.data_ptr(), K1, K2, Wn)
    return out
