#!/usr/bin/env python3
"""The inverse real FFT on the card against the CPU's, with and without the
imaginary parts of the DC and Nyquist bins, and the port's `istft` against
its CPU run.

    python3 tools/irfft_dc_check.py

A Vocos head gives raw phases, so its spectra carry an imaginary part at
the DC and Nyquist bins, which a Hermitian spectrum does not have.  The
CPU's irfft ignores it; this prints, per (batch, n_freqs, n_frames) of
1024-point transforms with random phases, the relative L2 of the card's
irfft against the CPU's as it is and with those parts zeroed, and of
`ops/stft.py::istft` on the card against the CPU.  Needs one CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = ((2, 513, 513), (8, 513, 513), (32, 513, 513), (32, 513, 40), (1, 513, 4000))


def rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def main() -> int:
    import torch

    from matcha_tts_tpu_torch.ops.stft import istft

    if not torch.cuda.is_available():
        print("irfft_dc_check: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    g = torch.Generator().manual_seed(0)
    for b, f, t in SHAPES:
        mag = torch.rand(b, f, t, generator=g) + 0.5
        phase = torch.randn(b, f, t, generator=g)
        kept = torch.ones(f, 1)
        kept[0] = kept[-1] = 0.0
        raw = torch.polar(mag, phase)
        dropped = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase) * kept)
        n = 2 * (f - 1)
        ref = torch.fft.irfft(raw.transpose(-1, -2), n=n, dim=-1)
        card_raw = torch.fft.irfft(raw.cuda().transpose(-1, -2), n=n, dim=-1)
        card_dropped = torch.fft.irfft(dropped.cuda().transpose(-1, -2), n=n, dim=-1)
        port = istft(mag.cuda(), phase.cuda(), n, n // 4, n)
        port_cpu = istft(mag, phase, n, n // 4, n)
        print(f"({b}, {f}, {t}): irfft card vs CPU {rel_l2(card_raw, ref):.3e}, with the DC "
              f"and Nyquist imaginary parts zeroed {rel_l2(card_dropped, ref):.3e}; istft card "
              f"vs CPU {rel_l2(port, port_cpu):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
