"""The port's interop and host utilities against the JAX package's, on the CPU.

* `params/convert.py::export_matcha` / `export_vocos` on the port's modules
  (and on their JAX-layout trees) give the JAX package's state dicts from the
  same trees, key for key and bit for bit; `convert_matcha` /
  `convert_vocos` of them give the trees back;
* `params/io.py::load_matcha_any` on a run directory that
  `Checkpointer.save` wrote (and on its `ckpt/`, and at a step) and on a
  Lightning `.ckpt` (the trained tone model), against the model saved and
  the CLI's loader;
* `utils/plot.py`'s two plots write their file, as the JAX package's do.
"""

import types

import numpy as np
import pytest
import torch

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.params import convert as jconvert
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.inference.cli import load_models
from matcha_tts_tpu_torch.models.matcha import MatchaTTS
from matcha_tts_tpu_torch.models.vocos import Vocos
from matcha_tts_tpu_torch.params import convert as tconvert
from matcha_tts_tpu_torch.params import export_matcha, export_vocos, load_matcha_any
from matcha_tts_tpu_torch.params.from_jax import flatten_tree, to_jax_tree
from matcha_tts_tpu_torch.train.loop import Checkpointer
from matcha_tts_tpu_torch.utils.plot import plot_alignment, plot_spectrogram

CKPT = "tests/golden/trained/matcha_tone.ckpt"


def _matcha_kw(prenet: bool, n_spks: int):
    return dict(n_spks=n_spks, spk_emb_dim=16,
                encoder=dict(n_feats=8, n_channels=32, filter_channels=64, n_heads=2,
                             n_layers=2, prenet=prenet),
                duration_predictor=dict(filter_channels_dp=32),
                decoder=dict(channels=(16, 32), attention_head_dim=8, num_heads=2, n_blocks=2,
                             num_mid_blocks=2),
                audio=dict(n_mels=8))


def _cfg(mod, kw):
    return mod.MatchaConfig(
        n_spks=kw["n_spks"], spk_emb_dim=kw["spk_emb_dim"],
        encoder=mod.EncoderConfig(**kw["encoder"]),
        duration_predictor=mod.DurationPredictorConfig(**kw["duration_predictor"]),
        decoder=mod.DecoderConfig(**kw["decoder"]), audio=mod.AudioConfig(**kw["audio"]))


def _assert_same_state_dict(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def _assert_same_tree(got, want):
    got, want = flatten_tree(got), flatten_tree(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), want[k], err_msg=k)


@pytest.mark.parametrize("prenet, n_spks", [(True, 1), (False, 3)])
def test_export_matcha_matches_jax_and_round_trips(prenet, n_spks):
    kw = _matcha_kw(prenet, n_spks)
    tc, jc = _cfg(tcfg, kw), _cfg(jcfg, kw)
    model = MatchaTTS(tc, seed=5, device="cpu")
    tree = to_jax_tree(model)
    want = jconvert.export_matcha(tree, jc)
    _assert_same_state_dict(export_matcha(model, tc), want)
    _assert_same_state_dict(export_matcha(tree, tc), want)
    _assert_same_tree(tconvert.convert_matcha(export_matcha(model, tc), tc), tree)


def test_export_vocos_matches_jax_and_round_trips():
    kw = dict(dim=32, intermediate_dim=64, num_layers=2)
    tc = tcfg.VocosConfig(**kw)
    voc = Vocos(tc, seed=3, device="cpu")
    tree = to_jax_tree(voc)
    want = jconvert.export_vocos(tree)
    _assert_same_state_dict(export_vocos(voc), want)
    _assert_same_tree(tconvert.convert_vocos(export_vocos(voc), tc), tree)


def _assert_same_module(got, want):
    gs, ws = got.state_dict(), want.state_dict()
    assert gs.keys() == ws.keys()
    for k in ws:
        assert torch.equal(gs[k], ws[k]), k


def test_load_matcha_any_reads_a_run_directory(tmp_path):
    kw = _matcha_kw(True, 1)
    tc = _cfg(tcfg, kw)
    ckpt = Checkpointer(tmp_path / "run" / "ckpt", keep=3)
    models = {}
    for step, seed in ((2, 11), (4, 12)):
        m = MatchaTTS(tc, seed=seed, device="cpu")
        state = types.SimpleNamespace(model=m, optimizer=torch.optim.Adam(m.parameters()))
        ckpt.save(step, state, tc, {"loss": float(step)})
        models[step] = m
    for path in (tmp_path / "run", tmp_path / "run" / "ckpt"):
        got, cfg = load_matcha_any(path, device="cpu")
        assert cfg == tc and isinstance(got, MatchaTTS)
        _assert_same_module(got, models[4])
    from matcha_tts_tpu_torch.params.io import load_run_matcha

    got, _ = load_run_matcha(tmp_path / "run", step=2, device="cpu")
    _assert_same_module(got, models[2])
    with pytest.raises(FileNotFoundError):
        load_run_matcha(tmp_path / "empty", device="cpu")


def test_load_matcha_any_reads_a_lightning_checkpoint():
    got, cfg = load_matcha_any(CKPT, device="cpu")
    want, want_cfg, _, _ = load_models(checkpoint=CKPT, device="cpu")
    assert cfg == want_cfg
    _assert_same_module(got, want)


@pytest.mark.parametrize("plot, shape", [(plot_spectrogram, (80, 100)),
                                         (plot_alignment, (40, 100))])
def test_plots_write_their_file(tmp_path, plot, shape):
    rng = np.random.default_rng(0)
    plot(rng.standard_normal(shape), tmp_path / "fig.png")
    # a PNG where matplotlib is present, else the array as .npy
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix in (".png", ".npy")
    assert files[0].stat().st_size > 0
