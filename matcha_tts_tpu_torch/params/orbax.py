"""Read what the JAX package's `train/loop.py::Checkpointer` writes (an Orbax
`CheckpointManager` run) without orbax, tensorstore, zarr or JAX.

Three layers, bottom up:

* **OCDBT** (`Ocdbt`), tensorstore's key-value store in files.  Every
  file it writes -- the manifest `manifest.ocdbt` and the B-tree nodes under
  `d/` -- is a 4-byte big-endian magic (0x0cdb3a2a the manifest, 0x0cdb20de
  a node), the file's length (uint64 LE), two varints (format version 0,
  compression 0 none or 1 zstd), the body, and a CRC-32C (uint32 LE) of all
  that precedes it.  The manifest's body is the config (uuid, manifest
  kind, limits, compression), a table of data files and the versions, each
  with its root node's location; the newest version is read.  A node's body
  is its height, its own table of data files and its entries, each column
  stored whole: keys prefix-coded against the previous key; in a leaf (height
  0) each value's length and kind, inline (the bytes follow in the node) or
  indirect (data file, offset); in an interior node each child's common key
  prefix, location and statistics.  A data file is (base path, relative
  path) under the store's directory; a node read from a file with base path
  B names its files under B.  Orbax writes one version and no version tree
  nodes, in a manifest of kind "single": anything else raises.
* **Zarr v2 arrays** (`read_zarr`): `<name>/.zarray` (shape, chunks, dtype,
  fill value, compressor; C order and the "." separator, as Orbax writes
  them, anything else raises) and one value per chunk under
  `<name>/<i>.<j>...`, each chunk full-sized with its edge padded,
  zstd-compressed or raw; a missing chunk is the fill value.  The
  dtypes are numpy's (`<f4`, `<f2`, `<i4`, `<i8`, `|b1`, ...) and
  `bfloat16`, which is read as uint16 and returned as a `torch.bfloat16`
  tensor (numpy has no bfloat16).
* **The Orbax layout** (`read_orbax_tree`): a run's `ckpt/` holds one
  directory per step, named by its number, finished when it holds
  `_CHECKPOINT_METADATA` (a directory being written has another name and is
  skipped).  A step holds one directory per item: `state/_METADATA` lists
  every leaf of the tree by its key path (key type 1 a sequence index, 2 a
  dict key) and the leaf's array is the zarr array named by the path's keys
  joined by "."; a leaf marked `skip_deserialize` is an empty dict or list,
  or None (optax's empty states).  `config/metadata` is the model config as
  JSON.  The arrays live in the item's OCDBT store (`state/manifest.ocdbt`).
  A run saved with zarr v3 (`use_zarr3` in `_METADATA`) raises.

Held against orbax-checkpoint 0.11.32 and tensorstore 0.1.80, the versions
its tests write with.
"""

from __future__ import annotations

import json
import math
import re
import struct
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from matcha_tts_tpu_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
_NO_LOCATION = 2**64 - 1  # offset and length of an empty tree's root


# -- CRC-32C (Castagnoli, reflected polynomial 0x82f63b78) -----------------

def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# -- OCDBT -----------------------------------------------------------------

class _Reader:
    """Reads a decoded body front to back."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def byte(self) -> int:
        return self.raw(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self):
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} bytes left over")


def decode_file(data: bytes, magic: int, what: str) -> bytes:
    """An OCDBT file (manifest or node) -> its body: magic, length, CRC-32C,
    version 0, compression none or zstd."""
    if len(data) < 18:
        raise ValueError(f"{what}: {len(data)} bytes is too short")
    if struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"{what}: magic {data[:4].hex()}, expected {magic:08x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise ValueError(f"{what}: the header says {length} bytes, the file has {len(data)}")
    want = struct.unpack("<I", data[-4:])[0]
    got = crc32c(data[:-4])
    if got != want:
        raise ValueError(f"{what}: CRC-32C {got:08x} does not match the stored {want:08x}")
    head = _Reader(data[:-4], what)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}, only 0 is known")
    body = data[head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"{what}: compression format {compression}, only 0 (none) and 1 (zstd)")


class DataFile(NamedTuple):
    base_path: str
    relative_path: str


class Location(NamedTuple):
    file: DataFile
    offset: int
    length: int


def _file_table(r: _Reader, transitive: str) -> List[DataFile]:
    """Prefix-coded paths: lengths of the prefix shared with the previous
    path (from the second on), of the rest, and of the base path, then the
    rests.  `transitive` is the base path of the file the table was read
    from."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev) or base[i] > prefix[i] + suffix[i]:
            raise ValueError(f"{r.what}: bad data file table entry {i}")
        path = prev[:prefix[i]] + r.raw(suffix[i])
        prev = path
        files.append(DataFile(transitive + path[:base[i]].decode(),
                              path[base[i]:].decode()))
    return files


def _locations(r: _Reader, files: List[DataFile], n: int) -> List[Optional[Location]]:
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    out = []
    for i, o, ln in zip(ids, offsets, lengths):
        if o == _NO_LOCATION and ln == _NO_LOCATION:
            out.append(None)
            continue
        if i >= len(files):
            raise ValueError(f"{r.what}: data file {i} of {len(files)}")
        out.append(Location(files[i], o, ln))
    return out


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    subtree = r.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: key {i} shares {prefix[i]} bytes of {len(prev)}")
        key = prev[:prefix[i]] + r.raw(suffix[i])
        if i and key <= prev:
            raise ValueError(f"{r.what}: keys out of order at entry {i}")
        if subtree[i] > len(key):
            raise ValueError(f"{r.what}: subtree prefix longer than key {i}")
        keys.append(key)
        prev = key
    return keys, subtree


class Statistics(NamedTuple):
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int


class Version(NamedTuple):
    generation: int
    root_height: int
    root: Optional[Location]  # None: an empty tree
    statistics: Statistics
    commit_time: int


class Manifest(NamedTuple):
    uuid: str
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: Optional[Tuple[str, int]]  # ("zstd", level) or None
    versions: List[Version]


class LeafEntry(NamedTuple):
    key: bytes  # relative to the node's key prefix
    value: Union[bytes, Location]  # inline bytes or an indirect value


class InteriorEntry(NamedTuple):
    key: bytes  # the child's first key, relative to the node's key prefix
    subtree_common_prefix: bytes  # the prefix of `key` that every key below shares
    location: Location
    statistics: Statistics


class Node(NamedTuple):
    height: int
    entries: List[Union[LeafEntry, InteriorEntry]]


def _statistics(r: _Reader, n: int) -> List[Statistics]:
    return [Statistics(*s) for s in zip(r.varints(n), r.varints(n), r.varints(n))]


def decode_manifest(data: bytes, what: str) -> Manifest:
    """A `manifest.ocdbt` file's bytes -> its config and versions.  Raises
    on a numbered manifest and on version tree nodes, which Orbax does not
    write."""
    r = _Reader(decode_file(data, MANIFEST_MAGIC, what), what)
    uuid = r.raw(16).hex()
    kind = r.varint()
    if kind != 0:
        raise ValueError(f"{what}: a numbered manifest (kind {kind}); Orbax writes a "
                         f"single manifest, and only that is read")
    max_inline, max_node, arity = r.varint(), r.varint(), r.byte()
    method = r.varint()
    if method == 1:
        compression = ("zstd", struct.unpack("<i", r.raw(4))[0])
    elif method == 0:
        compression = None
    else:
        raise ValueError(f"{what}: compression method {method}")
    files = _file_table(r, "")
    n = r.varint()
    if n == 0:
        raise ValueError(f"{what}: no version")
    gens, heights = r.varints(n), [r.byte() for _ in range(n)]
    roots = _locations(r, files, n)
    stats = _statistics(r, n)
    times = [r.u64() for _ in range(n)]
    n_nodes = r.varint()
    if n_nodes:
        raise ValueError(f"{what}: {n_nodes} version tree nodes (older generations "
                         f"kept out of line); Orbax writes none, and they are not read")
    r.end()
    return Manifest(uuid, max_inline, max_node, arity, compression,
                    [Version(*v) for v in zip(gens, heights, roots, stats, times)])


def decode_node(data: bytes, what: str, base_path: str = "") -> Node:
    """A B-tree node's bytes (read from a data file whose base path is
    `base_path`) -> its height and entries."""
    r = _Reader(decode_file(data, BTREE_MAGIC, what), what)
    height = r.byte()
    files = _file_table(r, base_path)
    n = r.varint()
    if n == 0:
        raise ValueError(f"{what}: empty node")
    keys, subtree = _keys(r, n, interior=height > 0)
    if height > 0:
        children = _locations(r, files, n)
        if any(c is None for c in children):
            raise ValueError(f"{what}: a child without a location")
        stats = _statistics(r, n)
        r.end()
        return Node(height, [InteriorEntry(k, k[:c], loc, st)
                             for k, c, loc, st in zip(keys, subtree, children, stats)])
    lengths = r.varints(n)
    kinds = r.varints(n)
    if any(k > 1 for k in kinds):
        raise ValueError(f"{what}: value kinds {sorted(set(kinds))}, only 0 (inline) "
                         f"and 1 (indirect)")
    n_ind = sum(kinds)
    ids, offsets = r.varints(n_ind), r.varints(n_ind)
    if any(i >= len(files) for i in ids):
        raise ValueError(f"{what}: data file ids {sorted(set(ids))} of {len(files)}")
    indirect = iter(zip(ids, offsets))
    values: List[Union[bytes, Location]] = []
    for kind, length in zip(kinds, lengths):
        if kind:
            i, offset = next(indirect)
            values.append(Location(files[i], offset, length))
        else:
            values.append(b"")
    for k, (kind, length) in enumerate(zip(kinds, lengths)):
        if not kind:  # the inline values follow, in entry order
            values[k] = r.raw(length)
    r.end()
    return Node(0, [LeafEntry(k, v) for k, v in zip(keys, values)])


class Ocdbt:
    """A read-only OCDBT store in a directory: `keys()` and `read(key)`.
    The whole tree of the newest version is indexed when the store opens;
    indirect values are read from their data files on demand."""

    def __init__(self, root):
        self.root = Path(root)
        path = self.root / "manifest.ocdbt"
        if not path.is_file():
            raise FileNotFoundError(f"no OCDBT manifest at {path}")
        self.manifest = decode_manifest(path.read_bytes(), str(path))
        self.version = max(self.manifest.versions, key=lambda v: v.generation)
        self._index: Dict[bytes, Union[bytes, Location]] = {}
        if self.version.root is not None:
            self._walk(self.version.root, self.version.root_height, b"")
        if len(self._index) != self.version.statistics.num_keys:
            raise ValueError(f"{path}: {len(self._index)} keys in the tree, the manifest "
                             f"says {self.version.statistics.num_keys}")

    def read_location(self, loc: Location) -> bytes:
        path = self.root / loc.file.base_path / loc.file.relative_path
        with open(path, "rb") as f:
            f.seek(loc.offset)
            data = f.read(loc.length)
        if len(data) != loc.length:
            raise ValueError(f"{path}: {len(data)} bytes at {loc.offset}, expected {loc.length}")
        return data

    def node(self, loc: Location) -> Node:
        return decode_node(self.read_location(loc),
                           f"{loc.file.base_path}{loc.file.relative_path}@{loc.offset}",
                           loc.file.base_path)

    def _walk(self, loc: Location, height: int, prefix: bytes):
        node = self.node(loc)
        if node.height != height:
            raise ValueError(f"{loc}: node height {node.height}, its parent says {height}")
        for e in node.entries:
            if height > 0:
                self._walk(e.location, height - 1, prefix + e.subtree_common_prefix)
            else:
                self._index[prefix + e.key] = e.value

    def keys(self) -> List[str]:
        return [k.decode() for k in sorted(self._index)]

    def read(self, key: str) -> Optional[bytes]:
        value = self._index.get(key.encode())
        if value is None or isinstance(value, bytes):
            return value
        return self.read_location(value)


# -- zarr v2 -----------------------------------------------------------------

def _fill(value, dtype: np.dtype, bf16: bool):
    if value is None:
        return 0
    if isinstance(value, str):
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[value]
    if bf16:  # the fill value's bfloat16 bits, rounded as torch rounds
        return int(torch.tensor(value, dtype=torch.bfloat16).view(torch.int16)) & 0xFFFF
    return np.asarray(value).astype(dtype)


def read_zarr(read: Callable[[str], Optional[bytes]], name: str):
    """The zarr v2 array `name` of a store (`read(key) -> bytes or None`):
    a numpy array, or a `torch.bfloat16` tensor for dtype bfloat16."""
    raw_meta = read(f"{name}/.zarray")
    if raw_meta is None:
        raise KeyError(f"no zarr array {name!r} (no {name}/.zarray)")
    meta = json.loads(raw_meta)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}, only 2")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {compressor}, only zstd or none")
    bf16 = meta["dtype"] == "bfloat16"
    if not isinstance(meta["dtype"], str):
        raise ValueError(f"{name}: structured dtype {meta['dtype']}")
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])
    if meta.get("order", "C") != "C":
        raise ValueError(f"{name}: order {meta['order']}, only C")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{name}: dimension separator {meta['dimension_separator']!r}, "
                         f"only '.'")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: shape {shape} with chunks {chunks}")
    out = np.full(shape, _fill(meta.get("fill_value"), dtype, bf16), dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        data = read(f"{name}/{'.'.join(map(str, idx)) or '0'}")
        if data is None:
            continue
        if compressor is not None:
            data = zstd.decompress(data)
        count = math.prod(chunks)
        if len(data) != count * dtype.itemsize:
            raise ValueError(f"{name}: chunk {idx} holds {len(data)} bytes, expected "
                             f"{count * dtype.itemsize}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    out = out.astype(dtype.newbyteorder("="), copy=False)
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


# -- the Orbax layout ----------------------------------------------------------

_STEP = re.compile(r"[0-9]+")
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
_EMPTY = {"Dict": dict, "List": list, "Tuple": list}  # empty containers; else None


def ckpt_dir(work_or_ckpt_dir) -> Path:
    """A run's work directory or its `ckpt/` -> the directory of steps."""
    d = Path(work_or_ckpt_dir).absolute()
    return d / "ckpt" if (d / "ckpt").exists() else d


def step_dirs(directory) -> Dict[int, Path]:
    """{step: directory} of the finished steps (named by a number, holding
    `_CHECKPOINT_METADATA`) directly under `directory`."""
    d = Path(directory)
    if not d.is_dir():
        return {}
    return {int(p.name): p for p in d.iterdir()
            if p.is_dir() and _STEP.fullmatch(p.name) and (p / "_CHECKPOINT_METADATA").is_file()}


def is_orbax_run(path) -> bool:
    return bool(step_dirs(ckpt_dir(path)))


def read_item_tree(item_dir, subtree: Optional[str] = None):
    """One item of a step (e.g. `<step>/state`), saved by Orbax's
    `StandardSave`/`PyTreeSave`: its tree, dicts and lists of numpy arrays
    (bfloat16 leaves as torch tensors) and None.  With `subtree`, only the
    leaves under that key of the top-level dict are read, and that subtree
    is returned."""
    item_dir = Path(item_dir)
    meta = json.loads((item_dir / "_METADATA").read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{item_dir}: saved as zarr v3, only v2 is read")
    read = Ocdbt(item_dir).read
    root: dict = {}
    for label, entry in meta["tree_metadata"].items():
        keys = entry["key_metadata"]
        if subtree is not None and not (keys and keys[0]["key_type"] == 2
                                        and str(keys[0]["key"]) == subtree):
            continue
        value_meta = entry.get("value_metadata", {})
        if value_meta.get("skip_deserialize"):
            value = _EMPTY.get(value_meta.get("value_type"), lambda: None)()
        elif value_meta.get("value_type") in _ARRAY_TYPES:
            value = read_zarr(read, ".".join(str(k["key"]) for k in keys))
            if value_meta["value_type"] == "scalar":
                value = value.item()
        else:
            raise ValueError(f"{item_dir}: leaf {label} of type "
                             f"{value_meta.get('value_type')!r} is not read")
        node = root
        for i, k in enumerate(keys):
            if k["key_type"] not in (1, 2):
                raise ValueError(f"{item_dir}: leaf {label}: key type {k['key_type']}")
            name = (int if k["key_type"] == 1 else str)(k["key"])
            if i == len(keys) - 1:
                node[(k["key_type"], name)] = value
            else:
                node = node.setdefault((k["key_type"], name), {})
    if subtree is None:
        return _containers(root, str(item_dir))
    if (2, subtree) not in root:
        raise KeyError(f"{item_dir}: no {subtree!r} in the tree")
    return _containers(root[(2, subtree)], f"{item_dir}: {subtree}")


def _containers(node, where: str):
    """{(key type, key): child} -> dicts (type 2) and lists (type 1)."""
    if not isinstance(node, dict):
        return node
    types = {t for t, _ in node}
    if len(types) > 1:
        raise ValueError(f"{where}: sequence and dict keys at one level")
    if types == {1}:
        idx = sorted(k for _, k in node)
        if idx != list(range(len(idx))):
            raise ValueError(f"{where}: sequence indices {idx}")
        return [_containers(node[(1, i)], where) for i in idx]
    return {k: _containers(v, where) for (_, k), v in node.items()}


def read_orbax_tree(run_dir, step: Optional[int] = None,
                    subtree: Optional[str] = None) -> Tuple[dict, Optional[dict]]:
    """(the train state's tree, the config dict or None) of a step of an
    Orbax run: the latest, or `step`.  `run_dir` is the work directory or its
    `ckpt/`.  Every JAX trainer saves its state as the item `state`.  With
    `subtree` (e.g. "params"), only that key of the state is read and
    returned."""
    d = ckpt_dir(run_dir)
    steps = step_dirs(d)
    if not steps:
        raise FileNotFoundError(f"no Orbax checkpoints under {d}")
    step = max(steps) if step is None else int(step)
    if step not in steps:
        raise FileNotFoundError(f"no step {step} under {d}: steps {sorted(steps)}")
    tree = read_item_tree(steps[step] / "state", subtree)
    config = steps[step] / "config" / "metadata"
    return tree, json.loads(config.read_text()) if config.is_file() else None
