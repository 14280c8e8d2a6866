"""Spans of the program's stages, on the profiler's clock.

`span(name, args)` marks a stage (`matcha.<layer>.<stage>`) for
`torch.profiler`, the only recorder: the profiler keeps the spans beside the
host operations and the device's kernels, on one clock, and writes them out
with its trace (`export_chrome_trace`).  To see them, run the server or a
job under `torch.profiler.profile(...)`; the spans of the server's handler,
batcher and prefetch threads need a profiler of every thread
(`_ExperimentalConfig(profile_all_threads=True)`).

With no profiler on, a span is one shared null context after a single flag
read.  The flag is `torch.autograd.profiler._is_profiler_enabled`, set while
any profiler records: `torch.autograd._profiler_enabled()` reads False on
threads that a profiler of every thread records.

`args` (ints and strings, such as a request's id) reach the trace as the
span's arguments where the profiler records shapes (`record_shapes=True`);
`record_function` drops a string argument, so a span with arguments is the
profiler's `_RecordFunctionFast`, which keeps them.  No span lies in the
code that `inference/export.py` traces.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Optional, Union

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

NULL = contextlib.nullcontext()


def span(name: str, args: Optional[Mapping[str, Union[int, str]]] = None):
    """A context that records `name` (with `args`) while a profiler is on."""
    if not _profiler._is_profiler_enabled:
        return NULL
    if args is None:
        return _profiler.record_function(name)
    return _RecordFunctionFast(name, (), dict(args))
