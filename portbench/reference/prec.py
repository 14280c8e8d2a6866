"""The precision every product of the reference runs in.

`Prec("fp32")` leaves operands as they are (float32; `strict_fp32()` turns
TF32 off).  `Prec("fp8")` is the control: each operand of a convolution or a
matrix product (weights and activations alike) is rounded to float8 e4m3
under a per-tensor scale that maps its largest magnitude to 448, the
format's largest finite value, and the product then accumulates in float32,
as an fp8 tensor-core path would (`__call__`).

`values` rounds the values of the one computation whose rounding changes
the function rather than perturbing it: the flow time's sinusoidal
embedding at scale 1000, whose argument reaches 900 rad.  The model
computes it in its compute dtype (bf16 keeps about 2 rad of a 900 rad
argument), so the reference rounds it as the configuration's compute dtype
does (`values_dtype`, bf16 for these configurations, each op's result
rounded); the control rounds it to e4m3.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def strict_fp32() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Prec:
    def __init__(self, kind: str = "fp32", values_dtype: str = "float32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind
        self.values_dtype = getattr(torch, values_dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product.  Under autograd the rounding passes the
        gradient straight through, as fp8 training's does."""
        x = x.float()
        if self.kind == "fp32":
            return x
        with torch.no_grad():
            scale = FP8_MAX / x.abs().amax().clamp_min(1e-30)
            q = (x * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (q - x).detach() if x.requires_grad else q

    def values(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        with torch.no_grad():
            if self.kind == "fp8":
                q = x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
            else:
                q = x.to(self.values_dtype).float()
        return x + (q - x).detach() if x.requires_grad else q
