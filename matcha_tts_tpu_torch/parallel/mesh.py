"""Data parallelism over `torch.distributed`: one process per rank.

The JAX package runs one controller over a `jax.sharding.Mesh`, and XLA
derives the gradient all-reduce from the shardings.  The port runs SPMD
instead, as torchrun starts it: every rank runs the same program on its own
rows of each global batch, and the collectives are written out.  The
names are the JAX package's (`parallel/mesh.py` there), so each function
has its counterpart:

* `make_mesh`, `make_mesh_2d`, `make_multislice_mesh` join (or check) the
  default process group and return a `DeviceMesh` with JAX's dim names
  ("data"; "data", "model"; "dcn", "data").  "model" stays replicated.
* `batch_sharding(mesh)` is this rank's share of a global batch: its row
  range over every data-parallel dim ("dcn" and "data") and the group those
  dims span.  `shard_batch` keeps a rank's rows of each array.
* `replicate` broadcasts a module's or an optimizer's tensors from rank 0.

The backend and the device are explicit: NCCL by default on the rank's
CUDA device `cuda:{LOCAL_RANK}`, gloo only when the caller asks for it.
Nothing here picks gloo, the CPU or a shared card by itself.

Only broadcast, all_reduce and barrier run here, on fp32, int32 or int64
tensors: gloo runs no other collective on CUDA tensors, and NCCL has no
int16.  A gather is an all_reduce SUM into a buffer with one zeroed slot
per rank (`gather_rows`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_PARALLEL_DIMS = ("dcn", "data")
_WIRE_DTYPES = (torch.float32, torch.int32, torch.int64)


def _choose(backend: Optional[str], device) -> tuple:
    """(backend, device) from the caller's choice and torchrun's LOCAL_RANK."""
    if device is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_rank >= count:
            raise RuntimeError(
                f"LOCAL_RANK={local_rank} has no CUDA device of its own (this host has "
                f"{count}); pass device= to choose one")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if backend is None:
        if device.type != "cuda":
            raise ValueError(f"no default backend on {device}: pass backend='gloo'")
        backend = "nccl"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL runs on CUDA devices only, not on {device}")
    return backend, device


class _Process:
    """The rank's device, recorded when the process joins the group."""

    device: Optional[torch.device] = None


def init_process(backend: Optional[str] = None, device=None, *,
                 init_method: Optional[str] = None, rank: Optional[int] = None,
                 world_size: Optional[int] = None) -> torch.device:
    """Join the default process group and return the rank's device.

    Without `init_method` the group comes from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).  If the process has
    joined already, the backend and device asked for must be the ones it
    joined with."""
    backend, device = _choose(backend, device)
    if dist.is_initialized():
        if dist.get_backend() != backend or _Process.device not in (None, device):
            raise ValueError(f"the process joined over {dist.get_backend()} on "
                             f"{_Process.device}, not {backend} on {device}")
        _Process.device = device
        return device
    if device.type == "cuda":
        torch.cuda.set_device(device)
        # the context exists before DeviceMesh looks for one: it would set a
        # device of its own from LOCAL_RANK otherwise
        torch.zeros(1, device=device)
    kw = {} if init_method is None else {"init_method": init_method, "rank": rank,
                                         "world_size": world_size}
    dist.init_process_group(backend, **kw)
    _Process.device = device
    return device


def rank_device() -> torch.device:
    """The device this rank joined with."""
    if _Process.device is None:
        raise RuntimeError("this process has not joined a group (make_mesh or init_process)")
    return _Process.device


def _mesh(shape: Sequence[int], names: Sequence[str], backend, device):
    from torch.distributed.device_mesh import init_device_mesh

    device = init_process(backend, device) if (backend or device or not dist.is_initialized()
                                               ) else rank_device()
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of {tuple(shape)} needs {int(np.prod(shape))} ranks, but "
                         f"the world has {world}: start that many "
                         f"(torchrun --nproc-per-node {int(np.prod(shape))})")
    return init_device_mesh(device.type, tuple(shape), mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, data_axis: str = "data", *,
              backend: Optional[str] = None, device=None):
    """1-D data-parallel mesh over the world's ranks (`n_devices`, if given,
    must be the world size: a process per rank has no spare devices to
    leave out)."""
    if not dist.is_initialized():
        init_process(backend, device)
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return _mesh((n,), (data_axis,), backend, device)


def make_mesh_2d(dp: int, mp: int, *, backend: Optional[str] = None, device=None):
    """("data", "model") mesh; the "model" dim is replicated."""
    return _mesh((dp, mp), ("data", "model"), backend, device)


def make_multislice_mesh(n_slices: int, per_slice: Optional[int] = None, *,
                         backend: Optional[str] = None, device=None):
    """("dcn", "data") mesh: data parallelism across `n_slices` groups of
    `per_slice` ranks, rank-major, so that each slice's ranks are
    consecutive (one host's cards under torchrun)."""
    if not dist.is_initialized():
        init_process(backend, device)
    world = dist.get_world_size()
    if per_slice is None:
        per_slice = world // n_slices
        if n_slices * per_slice != world:
            raise ValueError(
                f"{world} devices do not split into {n_slices} "
                f"slices; pass per_slice explicitly to use a subset")
    return _mesh((n_slices, per_slice), ("dcn", "data"), backend, device)


# ---------------------------------------------------------------------------
# a rank's share of a batch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """This rank's place among the data-parallel ranks: index `rank` of
    `world`, and the process group they form (None: the default group)."""

    rank: int
    world: int
    group: Optional[object] = None

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of `n`, which must split
        evenly over the ranks."""
        if n % self.world:
            raise ValueError(f"a global batch of {n} does not split over "
                             f"{self.world} data-parallel ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


def batch_sharding(mesh) -> BatchSharding:
    """The leading (batch) axis split over every data-parallel dim of the
    mesh ("dcn" and "data"); "model" stays replicated."""
    names = tuple(mesh.mesh_dim_names)
    shape = tuple(mesh.mesh.shape)
    coord = mesh.get_coordinate()
    dims = [i for i, name in enumerate(names) if name in DATA_PARALLEL_DIMS]
    rank, world = 0, 1
    for i in dims:
        rank, world = rank * shape[i] + coord[i], world * shape[i]
    if len(dims) == len(names):
        group = None
    elif len(dims) == 1:
        group = mesh.get_group(names[dims[0]])
    else:
        raise ValueError(f"mesh dims {names}: one data-parallel dim beside a replicated one")
    return BatchSharding(rank, world, group)


def shard_batch(mesh, batch: Dict) -> Dict[str, torch.Tensor]:
    """This rank's rows of each array or tensor in `batch`, on its device."""
    sh = batch_sharding(mesh)
    device = rank_device()
    out = {}
    for k, v in batch.items():
        rows = v[sh.rows(len(v))]
        out[k] = (torch.from_numpy(np.ascontiguousarray(rows)) if isinstance(rows, np.ndarray)
                  else rows).to(device)
    return out


@dataclasses.dataclass
class BatchRows:
    """Random draws at a global batch's shape, of which this rank keeps rows
    [lo, hi), and sums over the ranks.

    Every rank holds a generator seeded alike, so a row's numbers equal the
    ones it gets at world 1 (where the draw and the batch are the same).
    `total` sums a loss's denominator over `sharding`'s ranks (without
    gradient), so that a rank's loss is its numerator over the global
    denominator and the ranks' gradients sum to the global loss's.  The
    price: a rank draws `world` times the numbers it keeps."""

    generator: torch.Generator
    lo: int
    hi: int
    n: int
    sharding: Optional[BatchSharding] = None

    @classmethod
    def for_rank(cls, generator: torch.Generator, sharding: BatchSharding, local_b: int):
        n = local_b * sharding.world
        rows = sharding.rows(n)
        return cls(generator, rows.start, rows.stop, n, sharding)

    def _global(self, shape) -> tuple:
        return (self.n, *tuple(shape)[1:])

    def rand(self, shape, device) -> torch.Tensor:
        return torch.rand(self._global(shape), generator=self.generator,
                          device=device)[self.lo:self.hi]

    def randn(self, shape, device) -> torch.Tensor:
        return torch.randn(self._global(shape), generator=self.generator,
                           device=device)[self.lo:self.hi]

    def randint(self, high: int, shape, device) -> torch.Tensor:
        return torch.randint(0, high, self._global(shape), generator=self.generator,
                             device=device)[self.lo:self.hi]

    def total(self, x: torch.Tensor) -> torch.Tensor:
        if self.sharding is None or self.sharding.world == 1:
            return x
        t = x.detach().clone()
        all_reduce_sum(t, self.sharding.group)
        return t


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _wire(t: torch.Tensor) -> torch.Tensor:
    """`t` as a tensor the collectives carry on the rank's device."""
    device = rank_device()
    if t.dtype in _WIRE_DTYPES and t.device == device:
        return t
    dtype = t.dtype if t.dtype in _WIRE_DTYPES else (
        torch.float32 if t.is_floating_point() else torch.int32 if t.dtype in (
            torch.int16, torch.int8, torch.uint8, torch.bool) else torch.int64)
    return t.to(device=device, dtype=dtype)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """In place (through a wire copy when `t` needs one)."""
    w = _wire(t)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    if w is not t:
        t.copy_(w)
    return t


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    w = _wire(t)
    dist.all_reduce(w, op=dist.ReduceOp.MAX, group=group)
    if w is not t:
        t.copy_(w)
    return t


def any_rank(flag: bool, group=None) -> bool:
    """True on every rank when `flag` is true on any."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=rank_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group=None,
                     average: bool = False) -> None:
    """Sum (or average) the `.grad` of `params` over the ranks, through one
    flat fp32 buffer.  Every rank holds gradients for the same parameters
    (the same program ran on each)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    if average:
        flat /= dist.get_world_size(group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


def gather_rows(local: torch.Tensor, sharding: BatchSharding) -> torch.Tensor:
    """Every rank's `local` (the same shape on each) stacked in rank order
    along dim 0, on every rank: an all_reduce SUM into a buffer with one
    zeroed slot per rank.  int16 and bf16 travel as int32 and fp32 and come
    back in their own dtype."""
    w = _wire(local)
    buf = torch.zeros((sharding.world, *w.shape), dtype=w.dtype, device=w.device)
    buf[sharding.rank] = w
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=sharding.group)
    return buf.reshape(sharding.world * w.shape[0], *w.shape[1:]).to(local.dtype)


def broadcast_json(obj, group=None, src: int = 0):
    """`obj` (JSON-serialisable) from rank `src` to every rank, as int32 codes
    of its UTF-8 bytes after their count; other ranks pass None."""
    device = rank_device()
    mine = dist.get_rank() == src
    data = json.dumps(obj).encode() if mine else b""
    n = torch.tensor([len(data)], dtype=torch.int64, device=device)
    dist.broadcast(n, src=src, group=group)
    codes = (torch.tensor(list(data), dtype=torch.int32, device=device) if mine
             else torch.zeros(int(n.item()), dtype=torch.int32, device=device))
    dist.broadcast(codes, src=src, group=group)
    return json.loads(bytes(codes.cpu().tolist()).decode())


def replicate(mesh, obj):
    """Broadcast from rank 0, in place: a module's parameters and buffers,
    or an optimizer's state tensors (in parameter order).  Returns `obj`."""
    del mesh  # every rank of the world holds a replica
    if isinstance(obj, torch.optim.Optimizer):
        tensors = [v for group in obj.param_groups for p in group["params"]
                   for _, v in sorted(obj.state.get(p, {}).items())
                   if isinstance(v, torch.Tensor)]
    else:
        tensors = list(obj.state_dict().values())
    with torch.no_grad():
        for t in tensors:
            w = _wire(t)
            dist.broadcast(w, src=0)
            if w is not t:
                t.copy_(w)
    return obj


def mesh_from_flags(chips: Optional[int], backend: Optional[str], device: str):
    """The CLIs' (mesh, device): a 1-D mesh when torchrun started several
    ranks or `chips` asks for more than one, on the rank's device (`cuda`
    alone means `cuda:{LOCAL_RANK}`); else (None, device)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and (chips or 1) == 1:
        return None, device
    mesh = make_mesh(chips, backend=backend, device=None if device == "cuda" else device)
    return mesh, str(rank_device())


def resume_together(mesh, step: int) -> None:
    """Check that every rank resumed from the same step (a rank that read an
    older checkpoint index would run other collectives and hang)."""
    t = torch.tensor([step, -step], dtype=torch.int64, device=rank_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if int(t[0]) != -int(t[1]):
        raise RuntimeError(f"the ranks resumed from different steps ({-int(t[1])} to "
                           f"{int(t[0])})")


def is_main(mesh) -> bool:
    """Rank 0 writes checkpoints and logs; the others only compute."""
    return mesh is None or dist.get_rank() == 0
