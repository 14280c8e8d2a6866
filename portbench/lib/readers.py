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


def span_ms(run, span: str, per: str):
    """The device's busy plus idle time credited to the program's `span` in
    the profiled job or steps (`Trace.spans`), in ms per the profile's
    `per` ("calls": device calls; "steps": training steps).  None where the
    trace saw no device work, the program recorded no such span, or there
    is nothing to divide by."""
    prof = run.get("profile")
    if not prof or not prof.get(per) or prof["trace"].busy_s <= 0:
        return None
    s = prof["trace"].spans.get(span)
    if s is None:
        return None
    return 1e3 * (s["busy_s"] + s["idle_s"]) / prof[per]
