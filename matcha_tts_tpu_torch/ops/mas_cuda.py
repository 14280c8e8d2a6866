"""Monotonic alignment search as one CUDA kernel (`csrc/mas.cu`).

Replaces the TPU kernel `matcha_tts_tpu/ops/pallas/mas.py::
maximum_path_pallas`.  One block per batch item walks the column DP in
shared memory, keeps the backtrack bits as a bit lattice, walks them back and
writes the one-hot path: one read of the value table, one write of the path
(the source note in `csrc/mas.cu` says more).  Every cell is the same fp32
max and add as the plain version `ops/mas.py::maximum_path_plain`, so the two
give identical paths.

`maximum_path_cuda` takes CUDA tensors only; `ops/mas.py::maximum_path`
sends CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from matcha_tts_tpu_torch.ops import cuda_build

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES = {"mas": 0}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mas")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mas_path.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr]
        lib.mas_path.restype = i32
        lib.mas_smem_bytes.argtypes = [i32, i32, i32]
        lib.mas_smem_bytes.restype = i32
        lib.mas_error_string.argtypes = [i32]
        lib.mas_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def lengths_from_mask(mask: torch.Tensor):
    """(t_x, t_y) per item as int32: the valid x at y = 0 and the valid y at
    x = 0 of the attention-domain mask (B, T_x, T_y)."""
    m = mask.float()
    return (m[:, :, 0].sum(dim=1).to(torch.int32),
            m[:, 0, :].sum(dim=1).to(torch.int32))


def maximum_path_cuda(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """neg_cent (B, T_x, T_y) fp32 or bf16 on the card, mask of the same
    shape -> the one-hot path (B, T_x, T_y) in neg_cent's dtype."""
    if neg_cent.device.type != "cuda":
        raise ValueError(f"maximum_path_cuda takes CUDA tensors, got {neg_cent.device}")
    if neg_cent.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"MAS kernel takes float32 or bfloat16, got {neg_cent.dtype}")
    if neg_cent.dim() != 3 or tuple(mask.shape) != tuple(neg_cent.shape):
        raise ValueError(f"neg_cent {tuple(neg_cent.shape)} and mask "
                         f"{tuple(mask.shape)} must be the same (B, T_x, T_y)")
    if mask.device != neg_cent.device:
        raise ValueError(f"mask is on {mask.device}, neg_cent on {neg_cent.device}")
    if not neg_cent.is_contiguous():
        raise ValueError("neg_cent must be contiguous")
    lib = _lib()
    b, t_x, t_y = neg_cent.shape
    t_xs, t_ys = lengths_from_mask(mask)
    smem_bits = int(lib.mas_smem_bytes(t_x, t_y, 1) <= cuda_build.SMEM_LIMIT)
    if not smem_bits and lib.mas_smem_bytes(t_x, t_y, 0) > cuda_build.SMEM_LIMIT:
        raise ValueError(f"MAS kernel: T_x={t_x}, T_y={t_y} exceed shared memory")
    gbits = None
    if not smem_bits:
        gbits = torch.empty((b, t_y, (t_x + 31) // 32), dtype=torch.int32,
                            device=neg_cent.device)
    path = torch.empty_like(neg_cent)
    err = lib.mas_path(neg_cent.data_ptr(), t_xs.data_ptr(), t_ys.data_ptr(), b, t_x, t_y,
                       int(neg_cent.dtype == torch.bfloat16), smem_bits,
                       None if gbits is None else gbits.data_ptr(), path.data_ptr(),
                       torch.cuda.current_stream(neg_cent.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mas kernel launch failed: {lib.mas_error_string(err).decode()}")
    LAUNCHES["mas"] += 1
    return path
