"""Helpers that several metric readers share."""

import re
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "matcha_tts_tpu_torch" / "csrc"


def kernel_pattern(source: str) -> str:
    """A pattern matching the kernels that `csrc/<source>.cu` declares
    `__global__`, as whole words of a trace's kernel names."""
    text = (CSRC / f"{source}.cu").read_text()
    names = re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?(?:void\s+)?"
                       r"(\w+)\s*\(", text)
    if not names:
        return r"(?!)"
    return r"\b(" + "|".join(sorted(set(names))) + r")\b"


def idle_share(run):
    prof = run.get("profile")
    if not prof or prof["trace"].wall_s <= 0:
        return None
    t = prof["trace"]
    if t.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.wall_s)
