"""The port's Orbax reader (`params/orbax.py`, `native/zstd.py`) and
`params/io.py::load_orbax_matcha` against tensorstore, orbax and the JAX
package on the CPU.

* zstd: frames with and without their content size, truncated frames, a
  missing library;
* OCDBT: every key and value of a store as tensorstore lists and reads them,
  for a run written by the JAX package's `Checkpointer`, and for stores that
  tensorstore writes with small nodes (root height > 0, inline and indirect
  values), zstd-compressed or not, and each structure decoded (the
  manifest's config and versions, every node) against
  `tensorstore.ocdbt.dump`; a flipped byte fails the CRC-32C; a
  numbered manifest and version tree nodes (which Orbax does not write) are
  refused;
* zarr v2: arrays of each dtype the reader takes, written by tensorstore
  (its zarr format) over several chunks with padded edges, missing chunks and a
  fill value, in C order, in an OCDBT store (zstd) and in files (raw),
  against tensorstore's read; Fortran order and the "/" separator, which Orbax does
  not write, refused;
* the Orbax layout: the whole train state against orbax's own restore; a
  subtree of it read alone, touching no key outside it; a zarr v3 run
  refused;
  `load_orbax_matcha` bit for bit against `load_jax_tree` of the JAX
  package's `load_orbax_matcha` on the same run, with the same config, at
  the latest step and at `step=`, from the work directory and from `ckpt/`,
  at `tests/test_convert.py::tiny_cfg`, at `MatchaConfig()` and on a best-k
  run; `load_matcha_any` on both layouts;
* the committed fixture (`tests/golden/orbax_small/`, written by
  `tools/make_orbax_fixture.py`) equal to what the JAX package reads from
  it, and read in a subprocess where jax, orbax, tensorstore, zstandard and
  the JAX package cannot be imported, equal to its `.npz` sidecars.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.models.matcha import init_matcha
from matcha_tts_tpu.params.io import load_orbax_matcha as jax_load_orbax_matcha
from matcha_tts_tpu.train.distill import DistillConfig, create_distill_state
from matcha_tts_tpu.train.loop import Checkpointer as JaxCheckpointer
from matcha_tts_tpu.train.train_state import create_train_state
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.models.matcha import MatchaTTS
from matcha_tts_tpu_torch.native import zstd
from matcha_tts_tpu_torch.params import orbax
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree, read_npz
from matcha_tts_tpu_torch.params.io import load_matcha_any, load_orbax_matcha
from matcha_tts_tpu_torch.train.loop import Checkpointer as PortCheckpointer
from port_params import numpy_tree
from test_convert import tiny_cfg

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "golden" / "orbax_small"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(cfg, seed):
    return numpy_tree(lambda key: init_matcha(key, cfg), seed,
                      fixed={"mel_mean": cfg.audio.mel_mean, "mel_std": cfg.audio.mel_std})


def _write_run(root: Path, cfg, steps, monitor=None, keep=3, losses=None, distill=False):
    """A run as the JAX package's trainers write it: a TrainState with Adam's
    state per step, params drawn from the step's seed; with `distill`, a
    DistillState (the student's params, its EMA and Adam's state)."""
    ckpt = JaxCheckpointer(root / "ckpt", keep=keep, monitor=monitor)
    for i, step in enumerate(steps):
        if distill:
            state = create_distill_state(_params(cfg, 100 + step), DistillConfig())
            state = state._replace(ema_params=_params(cfg, 200 + step))
        else:
            state = create_train_state(_params(cfg, 100 + step), jcfg.TrainConfig())
        state = state._replace(step=jax.numpy.asarray(step, jax.numpy.int32))
        ckpt.save(step, state, cfg, metrics=None if losses is None else {"loss": losses[i]})
    return root


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    return _write_run(tmp_path_factory.mktemp("orbax") / "run", tiny_cfg(), (1, 2))


def _assert_same_state(got, want):
    gs, ws = got.state_dict(), want.state_dict()
    assert gs.keys() == ws.keys()
    for k in ws:
        assert torch.equal(gs[k], ws[k]), k


def _check_against_jax(run: Path, steps):
    """load_orbax_matcha against JAX's on `run` at the latest step (from the
    work directory) and at each of `steps` (from ckpt/)."""
    for path, step in [(run, None)] + [(run / "ckpt", s) for s in steps]:
        jparams, jc = jax_load_orbax_matcha(path, step)
        want_cfg = tcfg.config_from_dict(tcfg.MatchaConfig, jcfg.config_to_dict(jc))
        want, _ = load_jax_tree({"matcha": jax.device_get(jparams)}, want_cfg, device="cpu")
        got, cfg = load_orbax_matcha(path, step, device="cpu")
        assert cfg == want_cfg
        assert tcfg.config_to_dict(cfg) == jcfg.config_to_dict(jc)
        _assert_same_state(got, want)


# -- zstd ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 1000, 300_000])
def test_zstd_frames_with_and_without_their_size(n):
    """Frames that state their content size (one call) and frames that do
    not (the stream path), made by the zstandard package."""
    import zstandard

    data = bytes(np.random.default_rng(n).integers(0, 4, n, dtype=np.uint8))
    for frame in (zstandard.ZstdCompressor(level=1).compress(data),
                  zstandard.ZstdCompressor(level=3, write_content_size=False).compress(data)):
        assert zstd.decompress(frame) == data
    with pytest.raises(ValueError, match="truncated"):
        zstd.decompress(zstandard.ZstdCompressor(write_content_size=False).compress(
            data + b"tail")[:-3])
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"not zstd")


def test_zstd_names_a_missing_library(monkeypatch):
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "library_name", lambda: "libzstd-absent.so.9")
    with pytest.raises(OSError, match="libzstd-absent.so.9"):
        zstd.decompress(b"")


# -- OCDBT -------------------------------------------------------------------

def _ts_store(path: Path, compression=("zstd", 5)):
    """300 keys in one commit with 512-byte nodes and values of 0-59 bytes,
    inline up to 24: a tree of several levels, values of both kinds."""
    comp = None if compression is None else {"id": compression[0], "level": compression[1]}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": {"max_decoded_node_bytes": 512,
                                     "max_inline_value_bytes": 24,
                                     "compression": comp}}).result()
    rng = np.random.default_rng(0)
    txn = ts.Transaction()
    for i in range(300):
        key = f"arr{i % 7}.sub{i:04d}/{'x' * (i % 5)}"
        kv.with_transaction(txn).write(key, rng.bytes(int(rng.integers(0, 60)))).result()
    txn.commit_async().result()
    return path


def _tensorstore_items(path: Path) -> dict:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


@pytest.mark.parametrize("kind", ["checkpointer", "deep_zstd", "deep_raw"])
def test_ocdbt_matches_tensorstore(kind, tiny_run, tmp_path):
    if kind == "checkpointer":
        path = tiny_run / "ckpt" / "2" / "state"
    else:
        path = _ts_store(tmp_path / "s", ("zstd", 5) if kind == "deep_zstd" else None)
    store = orbax.Ocdbt(path)
    want = _tensorstore_items(path)
    assert store.keys() == sorted(want)
    for key, value in want.items():
        assert store.read(key) == value, key
    assert store.read("no/such/key") is None
    heights, kinds = _structures_match_dump(store)
    if kind == "checkpointer":
        assert heights == {0}
    else:  # several levels, values of both kinds
        assert max(heights) > 0 and kinds == {"inline_value", "indirect_value"}


def _loc(kind: str, loc) -> str:
    """tensorstore's form: kind:base path:relative path:offset:length."""
    return f"{kind}:{loc.file.base_path}:{loc.file.relative_path}:{loc.offset}:{loc.length}"


def _structures_match_dump(store):
    """Each structure the reader decodes -- the manifest's config and
    versions, then every B-tree node of the newest version -- against
    `tensorstore.ocdbt.dump` of the same store and location.  Returns the
    node heights met and the kinds of values."""
    kv = ts.KvStore.open(f"file://{store.root}/").result()
    dump = ts.ocdbt.dump(kv).result()
    m = store.manifest
    comp = None if m.compression is None else (
        {"id": "zstd", "level": m.compression[1]} if m.compression[1] else {"id": "zstd"})
    assert dump["config"] == {"uuid": m.uuid, "max_inline_value_bytes": m.max_inline_value_bytes,
                              "max_decoded_node_bytes": m.max_decoded_node_bytes,
                              "version_tree_arity_log2": m.version_tree_arity_log2,
                              "compression": comp}
    assert dump["version_tree_nodes"] == []
    assert len(dump["versions"]) == len(m.versions)
    for v, d in zip(m.versions, dump["versions"]):
        root = {"statistics": v.statistics._asdict()}
        if v.root is not None:
            root["location"] = _loc("btreenode", v.root)
        assert d == {"generation_number": v.generation, "root_height": v.root_height,
                     "commit_time": v.commit_time, "root": root}
    heights, kinds, todo = set(), set(), [store.version.root]
    while todo:
        loc = todo.pop()
        node, d = store.node(loc), ts.ocdbt.dump(kv, _loc("btreenode", loc)).result()
        heights.add(node.height)
        assert d["height"] == node.height and len(d["entries"]) == len(node.entries)
        for e, de in zip(node.entries, d["entries"]):
            assert de["key"] == e.key
            if node.height:
                assert de["subtree_common_prefix"] == e.subtree_common_prefix
                assert de["location"] == _loc("btreenode", e.location)
                assert de["statistics"] == e.statistics._asdict()
                todo.append(e.location)
            elif isinstance(e.value, bytes):
                assert set(de) == {"key", "inline_value"}
                assert de["inline_value"] == e.value
                kinds.add("inline_value")
            else:
                assert de == {"key": de["key"], "indirect_value": _loc("value", e.value)}
                kinds.add("indirect_value")
    return heights, kinds


@pytest.mark.parametrize("target", ["manifest", "node"])
def test_ocdbt_crc_catches_a_flipped_byte(target, tmp_path):
    path = _ts_store(tmp_path / "s")
    if target == "manifest":
        file, at = path / "manifest.ocdbt", 40
    else:  # a byte in the middle of the root node
        root = orbax.Ocdbt(path).version.root
        file, at = path / root.file.base_path / root.file.relative_path, root.offset + 60
    data = bytearray(file.read_bytes())
    data[at] ^= 0x10
    file.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        orbax.Ocdbt(path)


@pytest.mark.parametrize("kind", ["numbered_manifest", "version_tree_nodes"])
def test_ocdbt_refuses_what_orbax_does_not_write(kind, tmp_path):
    config = {"manifest_kind": "numbered"} if kind == "numbered_manifest" else {}
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": config}).result()
    for i in range(3 if kind == "numbered_manifest" else 40):  # 40 commits > arity 16
        kv.write(f"k{i}", b"v" * i).result()
    with pytest.raises(ValueError, match="numbered manifest" if kind == "numbered_manifest"
                       else "version tree nodes"):
        orbax.Ocdbt(tmp_path)


# -- zarr v2 -------------------------------------------------------------------

DTYPES = {"<f4": 1.5, "<f2": -2.0, "<i4": 7, "<i8": -3, "|b1": True, "bfloat16": 0.5}


def _as_bits(a):
    if isinstance(a, torch.Tensor):  # bfloat16
        return a.view(torch.int16).numpy().view(np.uint16)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a


@pytest.mark.parametrize("layout", ["ocdbt_zstd_C", "file_raw_C"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_zarr_matches_tensorstore(dtype, layout, tmp_path):
    store, comp, order = layout.split("_")
    kvstore = ({"driver": "ocdbt", "base": f"file://{tmp_path}/"} if store == "ocdbt"
               else {"driver": "file", "path": f"{tmp_path}/"})
    shape, chunks = [5, 7, 3], [2, 3, 2]
    arr = ts.open({"driver": "zarr", "kvstore": kvstore, "path": "a.b.0.c",
                   "metadata": {"dtype": dtype, "shape": shape, "chunks": chunks,
                                "compressor": {"id": "zstd", "level": 1} if comp == "zstd"
                                else None,
                                "fill_value": DTYPES[dtype], "order": order},
                   "create": True}).result()
    rng = np.random.default_rng(3)
    values = rng.standard_normal((4, 4, 3)) * 100
    # rows 1-4 and columns 0-3: chunks of row 0 and of columns 6 stay missing
    arr[1:5, 0:4, :].write(values.astype(arr.dtype.numpy_dtype)).result()
    want = arr.read().result()
    read = (orbax.Ocdbt(tmp_path).read if store == "ocdbt"
            else lambda k: (tmp_path / k).read_bytes() if (tmp_path / k).is_file() else None)
    got = orbax.read_zarr(read, "a.b.0.c")
    assert tuple(got.shape) == tuple(shape)
    if dtype == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
    else:
        assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(_as_bits(got), _as_bits(want))


@pytest.mark.parametrize("meta", [{"order": "F"}, {"dimension_separator": "/"}])
def test_zarr_refuses_what_orbax_does_not_write(meta, tmp_path):
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": f"{tmp_path}/"},
                   "path": "a", "metadata": {"dtype": "<f4", "shape": [3, 2], "chunks": [2, 2],
                                             "compressor": None, **meta},
                   "create": True}).result()
    arr.write(np.arange(6, dtype=np.float32).reshape(3, 2)).result()
    with pytest.raises(ValueError, match="only C" if "order" in meta else "only '.'"):
        orbax.read_zarr(lambda k: (tmp_path / k).read_bytes(), "a")


def test_zarr_scalar_and_nan_fill(tmp_path):
    kvstore = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    scalar = ts.open({"driver": "zarr", "kvstore": kvstore, "path": "step",
                      "metadata": {"dtype": "<i4", "shape": [], "chunks": [],
                                   "compressor": {"id": "zstd", "level": 1}},
                      "create": True}).result()
    scalar.write(np.int32(12)).result()
    empty = ts.open({"driver": "zarr", "kvstore": kvstore, "path": "nan",
                     "metadata": {"dtype": "<f4", "shape": [3], "chunks": [2],
                                  "fill_value": "NaN", "compressor": None},
                     "create": True}).result()
    empty[:1].write(np.float32([4.0])).result()
    store = orbax.Ocdbt(tmp_path)
    assert orbax.read_zarr(store.read, "step").item() == 12
    np.testing.assert_array_equal(orbax.read_zarr(store.read, "nan"), [4.0, np.nan, np.nan])


# -- the Orbax layout ------------------------------------------------------------

def _same_tree(got, want, path="state"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}.{i}")
    elif want is None:
        assert got is None, path
    else:
        w = np.asarray(want)
        assert got.dtype == w.dtype and got.shape == w.shape, path
        np.testing.assert_array_equal(got, w, err_msg=path)


def test_whole_state_matches_orbax_restore(tiny_run):
    import orbax.checkpoint as ocp

    mngr = ocp.CheckpointManager(tiny_run / "ckpt")
    for step in (1, 2):
        want = mngr.restore(step, args=ocp.args.Composite(
            state=ocp.args.StandardRestore(), config=ocp.args.JsonRestore()))
        tree, config = orbax.read_orbax_tree(tiny_run, step)
        _same_tree(tree, jax.device_get(want["state"]))
        assert config == want["config"]
        assert tree["opt_state"][0] is None  # clip_by_global_norm's empty state
        assert int(tree["step"]) == step


def test_leaf_types_match_orbax_restore(tmp_path):
    """Every kind of leaf Orbax's StandardSave writes: jax and numpy arrays
    (bfloat16, int64, float16), Python scalars, empty containers, None,
    tuples (restored as lists)."""
    import orbax.checkpoint as ocp

    tree = {"a": jax.numpy.arange(3, dtype=jax.numpy.bfloat16), "b": np.arange(4, dtype=np.int64),
            "c": 5, "d": 2.5, "e": {}, "f": [], "g": None, "i": True,
            "h": (jax.numpy.ones((2, 2)), {"x": np.float16(1.5)})}
    mngr = ocp.CheckpointManager(tmp_path, options=ocp.CheckpointManagerOptions(create=True))
    mngr.save(0, args=ocp.args.Composite(state=ocp.args.StandardSave(tree)))
    mngr.wait_until_finished()
    want = mngr.restore(0, args=ocp.args.Composite(state=ocp.args.StandardRestore()))["state"]
    got, config = orbax.read_orbax_tree(tmp_path)
    assert config is None
    assert got.pop("a").view(torch.int16).tolist() == np.asarray(want.pop("a")).view(
        np.int16).tolist()
    assert all(got[k] == want[k] and type(got[k]) is type(want[k]) for k in "cdefgi")
    _same_tree(got["h"], jax.device_get(want["h"]), "h")


@pytest.mark.parametrize("subtree", ["params", "opt_state", "step"])
def test_subtree_reads_only_its_keys(subtree, tiny_run, monkeypatch):
    whole, config = orbax.read_orbax_tree(tiny_run, 1)
    keys, read = [], orbax.Ocdbt.read
    monkeypatch.setattr(orbax.Ocdbt, "read", lambda self, k: keys.append(k) or read(self, k))
    got, got_config = orbax.read_orbax_tree(tiny_run, 1, subtree=subtree)
    assert got_config == config
    _same_tree(got, whole[subtree], subtree)
    assert keys and all(k.split(".")[0].split("/")[0] == subtree for k in keys), keys


def test_subtree_names_a_missing_key(tiny_run):
    with pytest.raises(KeyError, match="no 'ema_params'"):
        orbax.read_orbax_tree(tiny_run, subtree="ema_params")


def test_zarr3_run_is_refused(tmp_path):
    import orbax.checkpoint as ocp

    mngr = ocp.CheckpointManager(tmp_path, options=ocp.CheckpointManagerOptions(create=True),
                                 item_handlers={"state": ocp.PyTreeCheckpointHandler(
                                     use_zarr3=True)})
    mngr.save(0, args=ocp.args.Composite(state=ocp.args.PyTreeSave({"a": np.arange(3.0)})))
    mngr.wait_until_finished()
    with pytest.raises(ValueError, match="zarr v3"):
        orbax.read_orbax_tree(tmp_path)


def test_load_orbax_matcha_matches_jax_tiny(tiny_run):
    _check_against_jax(tiny_run, (1, 2))


def test_load_orbax_matcha_reads_a_distillation_run(tmp_path):
    """train/distill.py's DistillState keeps the student under `params`."""
    run = _write_run(tmp_path / "run", tiny_cfg(), (4,), distill=True)
    _check_against_jax(run, (4,))
    tree, _ = orbax.read_orbax_tree(run)
    assert set(tree) == {"step", "params", "ema_params", "opt_state"}


def test_load_orbax_matcha_matches_jax_full_width(tmp_path):
    """MatchaConfig(): two steps of the full-width state (about 70 MB each
    in params, three times that with Adam's moments)."""
    run = _write_run(tmp_path / "run", jcfg.MatchaConfig(), (3, 7))
    _check_against_jax(run, (3,))


def test_load_orbax_matcha_matches_jax_best_k(tmp_path):
    """fit's retention (monitor="loss"): the best (here keep=1) and the
    latest survive, and the latest is not the best."""
    run = _write_run(tmp_path / "run", tiny_cfg(), (1, 2, 3), monitor="loss", keep=1,
                     losses=(0.5, 0.9, 0.8))
    assert sorted(orbax.step_dirs(run / "ckpt")) == [1, 3]
    _check_against_jax(run, (1, 3))
    with pytest.raises(FileNotFoundError, match="no step 2"):
        load_orbax_matcha(run, 2, device="cpu")


def test_step_directories(tiny_run, tmp_path):
    """Only numbered directories holding _CHECKPOINT_METADATA are steps: a
    step being written (Orbax's tmp name) or unfinished is skipped."""
    import shutil

    ckpt = tmp_path / "ckpt"
    shutil.copytree(tiny_run / "ckpt", ckpt)
    shutil.copytree(ckpt / "2", ckpt / "9.orbax-checkpoint-tmp-1792317702")
    (ckpt / "8").mkdir()
    assert sorted(orbax.step_dirs(ckpt)) == [1, 2]
    got, _ = load_orbax_matcha(tmp_path, device="cpu")
    want, _ = load_orbax_matcha(tiny_run, 2, device="cpu")
    _assert_same_state(got, want)
    with pytest.raises(FileNotFoundError, match="no Orbax checkpoints"):
        load_orbax_matcha(tmp_path / "ckpt" / "8", device="cpu")


def test_load_matcha_any_reads_both_layouts(tiny_run, tmp_path):
    want, _ = load_orbax_matcha(tiny_run, device="cpu")
    for path in (tiny_run, tiny_run / "ckpt"):
        got, cfg = load_matcha_any(path, device="cpu")
        assert cfg == want.cfg
        _assert_same_state(got, want)
    port = PortCheckpointer(tmp_path / "port" / "ckpt")
    m = MatchaTTS(want.cfg, seed=3, device="cpu")
    port.save(5, types.SimpleNamespace(model=m, optimizer=torch.optim.Adam(m.parameters())),
              want.cfg, {"loss": 1.0})
    got, cfg = load_matcha_any(tmp_path / "port", device="cpu")
    assert cfg == want.cfg
    _assert_same_state(got, m)
    (tmp_path / "neither").mkdir()
    with pytest.raises(FileNotFoundError, match="neither the port's .* nor an Orbax run"):
        load_matcha_any(tmp_path / "neither", device="cpu")


# -- the committed fixture ---------------------------------------------------------

def test_fixture_matches_jax_load():
    config = json.loads((FIXTURE / "config.json").read_text())
    for step in (None, 1, 2):
        jparams, jc = jax_load_orbax_matcha(FIXTURE, step)
        assert jcfg.config_to_dict(jc) == config
        got, cfg = load_orbax_matcha(FIXTURE, step, device="cpu")
        assert tcfg.config_to_dict(cfg) == config
        want, _ = load_jax_tree({"matcha": jax.device_get(jparams)}, cfg, device="cpu")
        _assert_same_state(got, want)
    assert cfg.encoder.n_feats == tcfg.HiFiGANConfig().num_mels
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    assert size < 2 * 2**20, size


BLOCKED_READ = """
import json, sys
from pathlib import Path
BLOCKED = ("jax", "jaxlib", "orbax", "tensorstore", "zarr", "zstandard", "matcha_tts_tpu")
for name in BLOCKED:
    sys.modules[name] = None  # any import of these raises ImportError
sys.path.insert(0, sys.argv[1])
import torch
from matcha_tts_tpu_torch.config import config_to_dict
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree, read_npz
from matcha_tts_tpu_torch.params.io import load_orbax_matcha
fixture = Path(sys.argv[2])
config = json.loads((fixture / "config.json").read_text())
for step, sidecar in ((None, 2), (1, 1), (2, 2)):
    model, cfg = load_orbax_matcha(fixture, step, device="cpu")
    assert config_to_dict(cfg) == config
    want, _ = load_jax_tree({"matcha": read_npz(fixture / f"params_step{sidecar}.npz")}, cfg,
                            device="cpu")
    got, ref = model.state_dict(), want.state_dict()
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), (step, k)
loaded = [m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None]
assert not loaded, loaded
print("read without JAX")
"""


def test_fixture_reads_without_jax_orbax_or_tensorstore(tmp_path):
    res = subprocess.run([sys.executable, "-c", BLOCKED_READ, str(REPO), str(FIXTURE)],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "read without JAX" in res.stdout
