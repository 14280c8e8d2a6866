"""Run a function on `world` ranks in child processes, with a deadline.

`spawn(fn, world, backend, device, timeout_s, args)` starts one process per
rank (`torch.multiprocessing`, the spawn method), joins each to the default
group through a `file://` store in a temporary directory, and calls
`fn(rank, *args)` there.  It returns the ranks' return values in rank
order.  When a rank raises, or the deadline passes (a collective that
hangs), every rank is killed and `spawn` raises: a hung group fails
instead of hanging its caller.  The tests and `chip_smoke.py` run their
ranks through it; a deployment starts them with torchrun.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Sequence


class RankFailed(RuntimeError):
    """A rank raised, died or outlived the deadline."""


def _rank_main(fn: Callable, rank: int, world: int, backend: str, device: str,
               store: str, out_dir: str, args: Sequence) -> None:
    out = Path(out_dir) / f"rank{rank}"
    import torch.distributed as dist

    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world))
        from matcha_tts_tpu_torch.parallel.mesh import init_process

        init_process(backend, device.format(rank=rank), init_method=f"file://{store}",
                     rank=rank, world_size=world)
        result = fn(rank, *args)
        with open(out.with_suffix(".tmp"), "wb") as f:
            pickle.dump(result, f)
        out.with_suffix(".tmp").replace(out.with_suffix(".pkl"))
    except BaseException:  # noqa: BLE001 -- reported to the parent, which raises
        out.with_suffix(".errtmp").write_text(traceback.format_exc())
        out.with_suffix(".errtmp").replace(out.with_suffix(".err"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str, device: str, timeout_s: float,
          args: Sequence = ()) -> List:
    """`fn(rank, *args)` on ranks 0 .. world - 1; `device` may hold
    "{rank}" ("cuda:{rank}").  `fn` and `args` must pickle: `fn` by its
    import path."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="matcha_spawn_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, device, store, tmp, tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failure = None
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if (Path(tmp) / f"rank{r}.err").exists()
                          or (not p.is_alive() and not (Path(tmp) / f"rank{r}.pkl").exists())]
                if failed:
                    failure = f"rank {failed[0]} failed"
                    break
                if time.monotonic() > deadline:
                    failure = f"the ranks outlived their deadline of {timeout_s:.0f} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)
        errors = [f"rank {r}:\n{(Path(tmp) / f'rank{r}.err').read_text()}"
                  for r in range(world) if (Path(tmp) / f"rank{r}.err").exists()]
        missing = [r for r in range(world) if not (Path(tmp) / f"rank{r}.pkl").exists()]
        if failure or errors or missing:
            codes = [p.exitcode for p in procs]
            raise RankFailed(f"{failure or f'ranks {missing} returned nothing'} "
                             f"(exit codes {codes})\n" + "\n".join(errors))
        results = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))  # written by this module's rank processes
    return results
