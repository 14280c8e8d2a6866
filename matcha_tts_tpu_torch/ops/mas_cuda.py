"""Monotonic alignment search as one CUDA kernel (`csrc/mas.cu`).

Replaces the TPU kernel `matcha_tts_tpu/ops/pallas/mas.py::
maximum_path_pallas`.  One block of two warps per batch item: one warp runs
the column recurrence with the column in registers (rows lane + 32 r) and
no block barrier, fed by the other through a `cp.async` ring of value
chunks, which also zeroes the output a slice per chunk; the first warp then
walks the backtrack bits back, 32 columns a pass, and the block writes the
t_y ones.  The kernel counts t_x and t_y from the mask itself, as
`lengths_from_mask` does (the source note in `csrc/mas.cu` says more).
Every cell is the same fp32 max and add as the plain version
`ops/mas.py::maximum_path_plain`, so the two give identical paths.

`maximum_path_cuda` takes CUDA tensors only, with T_x <= MAX_T_X and T_y <=
MAX_T_Y (every training bucket: T_x <= 512, T_y <= 2048); beyond them it
raises.  `ops/mas.py::maximum_path` sends CPU tensors to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from matcha_tts_tpu_torch.ops import cuda_build

# Kernel launches, counted where the wrapper launches the kernel.
LAUNCHES = {"mas": 0}
MAX_T_X = 1024   # 32 rows a lane
MAX_T_Y = 16384  # the walked rows and two ring stages in shared memory


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mas")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mas_path.argtypes = [ptr, ptr, i64, i64, i64, i32, i32, i32, i32, i32, ptr, ptr,
                                 ptr]
        lib.mas_path.restype = i32
        lib.mas_plan.argtypes = [i32, i32, i32, ptr]
        lib.mas_plan.restype = i32
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


def check_shape(t_x: int, t_y: int) -> None:
    """Raises ValueError for a (T_x, T_y) the kernel cannot take."""
    if not (1 <= t_x <= MAX_T_X and 1 <= t_y <= MAX_T_Y):
        raise ValueError(f"MAS kernel takes 1 <= T_x <= {MAX_T_X} and 1 <= T_y <= {MAX_T_Y}, "
                         f"got T_x={t_x}, T_y={t_y}")


def plan(t_x: int, t_y: int, dtype: torch.dtype) -> dict:
    """The kernel's launch plan: rows a lane holds (`r`), ring `stages`,
    whether the bits stay in shared memory (`smem_bits`) and the block's
    shared bytes (`smem`).  Needs the library (a card)."""
    check_shape(t_x, t_y)
    out = (ctypes.c_int * 4)()
    err = _lib().mas_plan(t_x, t_y, int(dtype == torch.bfloat16), out)
    if err != 0:
        raise ValueError(f"MAS kernel has no plan for T_x={t_x}, T_y={t_y}")
    return dict(zip(("r", "stages", "smem_bits", "smem"), out))


def maximum_path_cuda(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """neg_cent (B, T_x, T_y) fp32 or bf16 on the card, mask of the same
    shape (read at column 0 and row 0 only) -> the one-hot path (B, T_x,
    T_y) in neg_cent's dtype."""
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
    b, t_x, t_y = neg_cent.shape
    p = plan(t_x, t_y, neg_cent.dtype)
    if mask.dtype not in (torch.float32, torch.bfloat16):
        mask = mask.float()  # the kernel sums the mask in fp32, as lengths_from_mask does
    gbits = None
    if not p["smem_bits"]:
        gbits = torch.empty((b, t_y, p["r"]), dtype=torch.int32, device=neg_cent.device)
    path = torch.empty_like(neg_cent)
    err = _lib().mas_path(neg_cent.data_ptr(), mask.data_ptr(), *mask.stride(),
                          int(mask.dtype == torch.bfloat16), b, t_x, t_y,
                          int(neg_cent.dtype == torch.bfloat16),
                          None if gbits is None else gbits.data_ptr(), path.data_ptr(),
                          torch.cuda.current_stream(neg_cent.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mas kernel launch failed: {_lib().mas_error_string(err).decode()}")
    LAUNCHES["mas"] += 1
    return path
