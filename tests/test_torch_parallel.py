"""The port's data parallelism on the CPU over gloo (`parallel/`, and the
trainers under a mesh: `train_state.train_step`, `train/loop.py::fit`,
`train/distill.py::distill_step`, the GAN steps and `vocoder_cli
--data_parallel`).

JAX shows data parallelism to be invisible on its virtual 8-device mesh
(`tests/test_train.py`, `tests/test_vocoder_train.py`); the port runs one
process per rank, so these tests hold world 2 and world 4 to world 1 (the
path without a mesh) on the same seeds and inputs.  Every case of one world
size runs in one spawned group (`tests/torch_parallel_ranks.py`), with a
deadline of 120 s after which the ranks are killed and the test fails:

* the mesh helpers at world 2 and 4, JAX's multislice error text, and the
  explicit backend and device;
* `train_step` at world 2 with dropout on and rows whose mask sums differ
  between the ranks: the losses and the pre-clip norm within rtol 1e-4, the
  parameters after Adam within atol 1e-4, the reduced gradient (an SGD step
  at lr 1) within rel L2 1e-4, `eval_step` within rtol 1e-4; plain DDP's
  per-rank mean misses those bounds;
* the 2 x 2 ("dcn", "data") mesh's step against world 1;
* `fit` for 2 steps and a resume to 3: rank 0 alone writes, and the log
  equals world 1's;
* `distill_step` (reflow and consistency) and a GAN step pair: losses
  within rtol 1e-4, updates within rel L2 1e-4;
* `vocoder_cli --debug_tiny --data_parallel` for 2 steps against world 1;
* the distillation CLI with `--chips 2` against world 1, and a SIGTERM on
  one rank stopping both after the same step.
"""

import json
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from matcha_tts_tpu_torch.parallel import launch
from matcha_tts_tpu_torch.parallel import mesh as pmesh

DEADLINE_S = 120
TEACHER = str(Path(__file__).resolve().parent / "golden" / "trained" / "matcha_tone.ckpt")


def _rel(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


def _corpus(root: Path) -> str:
    """Eight sine WAVs of 0.40-0.89 s at 22050 Hz, six to train and two to
    validate (a validation batch of 2 splits over 2 ranks)."""
    (root / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(0)
    texts = ["Hello world.", "The canoe slid on planks.", "Good morning to you!",
             "It is easy to tell.", "A large size in stockings.", "Glue the sheet.",
             "These days a chicken leg.", "Rice is often served."]
    lines = []
    for i, text in enumerate(texts):
        n = int(22050 * (0.4 + 0.07 * i))
        w = (0.3 * np.sin(2 * np.pi * (150 + 20 * i) * np.arange(n) / 22050)
             + 0.01 * rng.standard_normal(n))
        with wave.open(str(root / "wavs" / f"u{i}.wav"), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(22050)
            f.writeframes((w * 32767).astype(np.int16).tobytes())
        lines.append(f"{root}/wavs/u{i}.wav|{text}\n")
    (root / "train.txt").write_text("".join(lines[:6]))
    (root / "val.txt").write_text("".join(lines[6:]))
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(tmp_path_factory.mktemp("corpus"))


@pytest.fixture(scope="module")
def groups(corpus, tmp_path_factory):
    """The world-2 and world-4 groups, started at once; they run while the
    test process computes world 1."""
    work = tmp_path_factory.mktemp("world2")
    return (R.in_background(2, R.trainers_rank, (corpus, str(work), TEACHER), DEADLINE_S),
            work,
            R.in_background(4, R.multislice_rank, (), DEADLINE_S))


@pytest.fixture(scope="module")
def world2(groups, world1):
    return groups[0].result(), groups[1]


@pytest.fixture(scope="module")
def world4(groups, world1):
    return groups[2].result()


@pytest.fixture(scope="module")
def world1(groups, corpus, tmp_path_factory):
    work = tmp_path_factory.mktemp("world1")
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        torch.set_num_threads(1)
        try:
            out = {"train": R.train_case(None), "distill": R.distill_case(None),
                   "consistency": R.distill_case(None, "consistency"),
                   "gan": R.gan_case(None), "multislice": R.multislice_case(None),
                   "fit": R.fit_case(None, corpus, str(work / "fit")),
                   "vocoder_cli": R.vocoder_cli_case(None, corpus, str(work / "voc")),
                   "distill_cli": R.distill_cli_case(None, str(work / "distill"), TEACHER)}
        finally:
            torch.set_num_threads(threads)
    return out, work


def test_mesh_helpers_world2(world2):
    ranks, _ = world2
    assert [r["names"] for r in ranks] == [("data",)] * 2
    assert [r["sharding"] for r in ranks] == [0, 1]
    assert "needs 3 ranks, but the world has 2" in ranks[0]["make_mesh"]
    assert ranks[0]["make_multislice_mesh"] == (
        "2 devices do not split into 3 slices; pass per_slice explicitly to use a subset")


def test_mesh_helpers_world4(world4):
    assert [r["names"] for r in world4] == [("dcn", "data")] * 4
    assert [r["rows"] for r in world4] == [(k, 4) for k in range(4)]
    # ("data", "model"): the model dim keeps the same rows
    assert [r["rows_2d"] for r in world4] == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert world4[0]["error"] == (
        "4 devices do not split into 3 slices; pass per_slice explicitly to use a subset")


def test_backend_and_device_are_explicit(monkeypatch):
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        pmesh.init_process(device="cpu")
    with pytest.raises(ValueError, match="NCCL runs on CUDA devices only"):
        pmesh.init_process("nccl", "cpu")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=1 has no CUDA device"):
        pmesh.make_mesh(backend="gloo")
    assert not torch.distributed.is_initialized()
    sh = pmesh.BatchSharding(1, 2)
    assert sh.rows(6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not split"):
        sh.rows(5)


def test_spawn_fails_a_group_that_raises_or_hangs():
    with pytest.raises(launch.RankFailed, match="(?s)failed.*ValueError: rank 1 raised"):
        launch.spawn(R.failing_rank, 2, "gloo", "cpu", DEADLINE_S, ("raise",))
    with pytest.raises(launch.RankFailed, match="outlived their deadline of 2 s"):
        launch.spawn(R.failing_rank, 2, "gloo", "cpu", 2, ("hang",))


@pytest.mark.parametrize("rank", [0, 1])
def test_train_step_world2_matches_world1(world2, world1, rank):
    got, want = world2[0][rank]["train"], world1[0]["train"]
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-4)
    assert _rel(got["grad"], want["grad"]) < 1e-4
    for k, v in want["eval"].items():
        np.testing.assert_allclose(got["eval"][k], v, rtol=1e-4, err_msg=k)


def test_per_rank_mean_misses_the_bound(world2, world1):
    """Plain DDP's average of per-rank means: the ranks' mask sums differ,
    so its loss and gradient are not the global batch's."""
    want = world1[0]["train"]
    got = world2[0][0]["per_rank_mean"]
    assert abs(got["loss"] / want["metrics"]["loss"] - 1.0) > 1e-4
    assert _rel(got["grad"], want["grad"]) > 1e-4


def test_multislice_mesh_matches_1d(world4, world1):
    want = world1[0]["multislice"]
    for r in world4:
        np.testing.assert_allclose(r["step"]["loss"], want["loss"], rtol=1e-4)
        assert _rel(r["step"]["grad"], want["grad"]) < 1e-4


def _log(work: Path):
    return [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]


def test_fit_world2_writes_on_rank0_and_resumes(world2, world1):
    ranks, work2 = world2
    got, want = ranks[0]["fit"], world1[0]["fit"]
    assert got["steps"] == want["steps"] == (2, 3) and ranks[1]["fit"]["steps"] == (2, 3)
    np.testing.assert_allclose(got["params"], want["params"], atol=1e-4)
    np.testing.assert_array_equal(ranks[1]["fit"]["params"], got["params"])
    log2, log1 = _log(work2 / "fit"), _log(world1[1] / "fit")
    # one line per step and per validation: a second writer would double them
    assert [(r["step"], r["split"]) for r in log2] == [(r["step"], r["split"]) for r in log1]
    for a, b in zip(log2, log1):
        for k in ("loss", "dur_loss", "prior_loss", "cfm_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=f"{k} at {a['step']}")
        if a["split"] == "train":
            assert a["frames_in_batch"] == b["frames_in_batch"]
    index = json.loads((work2 / "fit" / "ckpt" / "index.json").read_text())
    assert sorted(map(int, index)) == [2, 3]


@pytest.mark.parametrize("loss", ["distill", "consistency"])
def test_distill_step_world2_matches_world1(world2, world1, loss):
    want = world1[0][loss]
    for r in world2[0]:
        got = r[loss]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
        assert _rel(got["grad"], want["grad"]) < 1e-4


def test_gan_step_pair_world2_matches_world1(world2, world1):
    want = world1[0]["gan"]
    for r in world2[0]:
        got = r["gan"]
        for k in ("disc_loss", "gen_loss", "mel_l1", "fm_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        assert _rel(got["disc_update"], want["disc_update"]) < 1e-4
        assert _rel(got["gen_update"], want["gen_update"]) < 1e-4


def test_vocoder_cli_data_parallel_matches_world1(world2, world1):
    ranks, work2 = world2
    want = world1[0]["vocoder_cli"]
    for r in ranks:
        assert r["vocoder_cli"]["step"] == 2
        np.testing.assert_allclose(r["vocoder_cli"]["gen"], want["gen"], atol=1e-4)
    log2, log1 = _log(work2 / "voc"), _log(world1[1] / "voc")
    assert [r["step"] for r in log2] == [r["step"] for r in log1] == [1, 2]
    for a, b in zip(log2, log1):
        for k in ("disc_loss", "gen_loss", "mel_l1", "fm_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


def test_distill_cli_with_chips_matches_world1(world2, world1):
    """`distill --chips 2`: `distill_fit(mesh=)` from the trained teacher, the
    student saved by rank 0, equal to world 1's after Adam's two steps."""
    for r in world2[0]:
        np.testing.assert_allclose(r["distill_cli"], world1[0]["distill_cli"], atol=1e-4)


def test_a_signal_on_one_rank_stops_every_rank(world2):
    """Rank 1 alone gets a SIGTERM after step 1 of 5: both ranks stop after
    step 1 (the flag is all-reduced each step) and rank 0 checkpoints it."""
    ranks, work2 = world2
    assert [r["signal"] for r in ranks] == [1, 1]
    index = json.loads((work2 / "signal" / "ckpt" / "index.json").read_text())
    assert sorted(map(int, index)) == [1]
