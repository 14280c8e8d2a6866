"""The port's inference CLI and what it loads, against the JAX package on the
CPU: the Lightning checkpoint converter (the trained
`tests/golden/trained/matcha_tone.ckpt` gives the JAX tree leaf for leaf,
with the same reconstructed config), synthesis from that checkpoint with the
CFM noise injected (encoder atol 1e-4, durations equal, mel atol 1e-3), the
HiFi-GAN converter with weight-norm folding (exact; the generator it loads
matches JAX's at atol 1e-4), `main` end to end with `--device cpu`, the
long form and `--vocoder-family vocos` through `main`, and checkpoint resolution on
local paths and a localhost server (the port's copy of `utils/fetch.py`)."""

import functools
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.models import hifigan as jhifigan
from matcha_tts_tpu.models.matcha import synthesize as jsynthesize
from matcha_tts_tpu.models.text_encoder import text_encoder as jtext_encoder
from matcha_tts_tpu.params import convert as jconvert
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.inference import cli
from matcha_tts_tpu_torch.params import convert as tconvert
from matcha_tts_tpu_torch.params.from_jax import flatten_tree, load_jax_tree
from matcha_tts_tpu_torch.utils import fetch
from matcha_tts_tpu_torch.utils.wav import read_wav, write_wav

CKPT = Path(__file__).resolve().parent / "golden" / "trained" / "matcha_tone.ckpt"


@functools.lru_cache(maxsize=1)
def _trained():
    sd, hyper = tconvert.load_torch_checkpoint(CKPT)
    tc = tcfg.config_from_dict(tcfg.MatchaConfig, hyper)
    jc = jcfg.config_from_dict(jcfg.MatchaConfig, hyper)
    return sd, tc, jc


def test_trained_checkpoint_converts_like_jax():
    sd, tc, jc = _trained()
    jsd, jhyper = jconvert.load_torch_checkpoint(CKPT)
    assert tcfg.config_to_dict(tc) == jcfg.config_to_dict(jc) == jhyper
    got = flatten_tree(tconvert.convert_matcha(sd, tc))
    want = flatten_tree(jconvert.convert_matcha(jsd, jc))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_trained_checkpoint_synthesizes_like_jax():
    """Encoder and durations first (they round to whole frames), then the
    mel of 10 Euler steps from the same noise."""
    sd, tc, jc = _trained()
    params = jconvert.convert_matcha(sd, jc)
    model, _ = load_jax_tree({"matcha": tconvert.convert_matcha(sd, tc)}, tc, device="cpu")
    rng = np.random.default_rng(0)
    lengths = np.array([37, 22])
    x = np.zeros((2, 64), np.int64)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.integers(1, 178, n)
    mu, logw, _ = jtext_encoder(params["encoder"], jnp.asarray(x), jnp.asarray(lengths),
                                jc.encoder, jc.duration_predictor)
    with torch.no_grad():
        tmu, tlogw, _ = model.encoder(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), atol=1e-4)
    np.testing.assert_allclose(tlogw.numpy(), np.asarray(logw), atol=1e-4)

    key = jax.random.PRNGKey(3)
    t_y = 256
    ref = jsynthesize(params, key, jnp.asarray(x), jnp.asarray(lengths), jc,
                      n_timesteps=10, t_y_max=t_y, temperature=0.667, length_scale=1.0)
    z = np.array(jax.random.normal(key, (2, t_y, jc.encoder.n_feats), jnp.float32))
    with torch.no_grad():
        got = model.synthesize(torch.from_numpy(x), torch.from_numpy(lengths), n_timesteps=10,
                               t_y_max=t_y, temperature=0.667, z=torch.from_numpy(z))
    np.testing.assert_array_equal(got.durations.numpy(), np.asarray(ref.durations))
    np.testing.assert_array_equal(got.y_lengths.numpy(), np.asarray(ref.y_lengths))
    assert int(got.y_lengths.min()) > 50
    np.testing.assert_allclose(got.mel.numpy(), np.asarray(ref.mel), atol=1e-3)


def _hifigan_state_dict(hc, seed):
    """A reference-layout HiFi-GAN generator state dict with weight norm split
    into weight_g / weight_v, drawn with numpy."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, o, i, w, transposed=False):
        shape = (i, o, w) if transposed else (o, i, w)
        sd[f"{name}.weight_v"] = rng.standard_normal(shape).astype(np.float32)
        sd[f"{name}.weight_g"] = (0.5 + rng.random((shape[0], 1, 1))).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.standard_normal(o)).astype(np.float32)

    ch = hc.upsample_initial_channel
    conv("conv_pre", ch, hc.num_mels, 7)
    n_k = len(hc.resblock_kernel_sizes)
    for i, k in enumerate(hc.upsample_kernel_sizes):
        cin, cout = ch // 2 ** i, ch // 2 ** (i + 1)
        conv(f"ups.{i}", cout, cin, k, transposed=True)
        for j, (kk, dd) in enumerate(zip(hc.resblock_kernel_sizes, hc.resblock_dilation_sizes)):
            for m in range(len(dd)):
                for which in ("convs1", "convs2"):
                    conv(f"resblocks.{i * n_k + j}.{which}.{m}", cout, cout, kk)
    conv("conv_post", 1, ch // 2 ** len(hc.upsample_rates), 7)
    return sd


def test_fold_weight_norm_and_convert_hifigan_match_jax():
    jc = jcfg.HiFiGANConfig(upsample_initial_channel=32)
    tc = tcfg.config_from_dict(tcfg.HiFiGANConfig, jcfg.config_to_dict(jc))
    sd = _hifigan_state_dict(jc, 4)
    folded = tconvert.fold_weight_norm(sd)
    want_folded = jconvert.fold_weight_norm(sd)
    assert folded.keys() == want_folded.keys()
    assert not any(k.endswith(("weight_g", "weight_v")) for k in folded)
    for k in want_folded:
        np.testing.assert_array_equal(folded[k], want_folded[k], err_msg=k)
    tree, want = tconvert.convert_hifigan(sd, tc), jconvert.convert_hifigan(sd, jc)
    got, ref = flatten_tree(tree), flatten_tree(want)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    _, voc = load_jax_tree({"vocoder": tree}, tcfg.MatchaConfig(), tc, device="cpu")
    mel = np.random.default_rng(4).standard_normal((1, 8, 80)).astype(np.float32)
    wav = voc(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(wav, np.asarray(jhifigan.generator(want, jnp.asarray(mel), jc)),
                               atol=1e-4)


def test_cli_writes_a_wav_from_the_trained_checkpoint(tmp_path, monkeypatch, capsys):
    """`main` on the CPU with the trained checkpoint, int8 vocoder levels and
    the denoiser: the wav holds 256 samples per mel frame."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out.wav"
    cli.main(["--text", "A tone for the test.", "--device", "cpu", "--checkpoint", str(CKPT),
              "--nfe", "2", "--mrf-kernel", "int8", "--denoise", "0.00025",
              "--output", str(out)])
    printed = capsys.readouterr().out
    assert "Model config reconstructed from checkpoint hyper_parameters." in printed
    frames = int(re.search(r"Mel Shape: \(80, (\d+)\)", printed).group(1))
    wav, sr = read_wav(out)
    assert sr == 22050 and len(wav) == 256 * frames and np.isfinite(wav).all()
    assert "RTF" in printed
    assert (tmp_path / "alignment.png").exists() or (tmp_path / "alignment.npy").exists()


# The long-form cases (`--long-form`, and a `|` in the text) raised until the
# long form was ported, and `--vocoder-family vocos` until Vocos was; they now
# run on the CPU, on the small models of the slice tests, and write
# `Synthesizer.synthesize_long`'s wav (long form) or `synthesize`'s (Vocos; the
# family reaches `load_models`).  The ids keep the cases' names.
@pytest.mark.parametrize("argv,family", [(["--long-form"], "hifigan"),
                                         (["--text", "One. | Two."], "hifigan"),
                                         (["--vocoder-family", "vocos"], "vocos")],
                         ids=["argv0-item 13", "argv1-item 13", "argv2-item 10"])
def test_unported_cli_modes_raise(argv, family, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "x.wav"
    from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
    from port_params import small_synth_weights, small_vocos_weights

    _, _, mp, vp, tc, th = small_synth_weights()
    if family == "vocos":
        _, vp, th = small_vocos_weights()
    model, voc = load_jax_tree({"matcha": mp, "vocoder": vp}, tc, th, device="cpu")
    families = []

    def load(*a, vocoder_family="hifigan", **kw):
        families.append(vocoder_family)
        return model, tc, voc, th

    monkeypatch.setattr(cli, "load_models", load)
    cli.main(argv + ["--device", "cpu", "--nfe", "2", "--seed", "4", "--output", str(out)])
    assert families == [family]
    text = argv[1] if argv[0] == "--text" else "Hello! I am running on the PyTorch port."
    syn = Synthesizer(model, tc, voc, th, device="cpu")
    kw = dict(n_timesteps=2, temperature=0.667, length_scale=1.0, seed=4)
    want = syn.synthesize(text, **kw) if family == "vocos" else syn.synthesize_long(text, **kw)
    assert len(Synthesizer.split_text(text)) == 2
    wav, sr = read_wav(out)
    assert sr == 22050 and wav.shape == want.wav.shape and np.abs(want.wav).max() > 1e-3
    assert np.abs(wav - want.wav).max() <= 1.0 / 32767 + 1e-6
    assert f"Mel Shape: (80, {want.mel.shape[1]})" in capsys.readouterr().out


def test_wav_round_trip(tmp_path):
    audio = np.sin(np.linspace(0, 40, 2205)).astype(np.float32) * 0.5
    write_wav(tmp_path / "a.wav", audio, 22050)
    back, sr = read_wav(tmp_path / "a.wav")
    assert sr == 22050 and np.abs(back - audio).max() <= 1.0 / 32767 + 1e-6


def test_fetch_local_path_and_local_server(tmp_path, monkeypatch):
    monkeypatch.setenv("MATCHA_TPU_CACHE", str(tmp_path / "cache"))
    assert fetch.resolve_checkpoint(str(CKPT)) == CKPT
    body = CKPT.read_bytes()
    hits = []

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            hits.append(self.path)
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/ckpt/matcha_tone.ckpt"
        path = fetch.resolve_checkpoint(url)
        assert path.read_bytes() == body and path.parent == tmp_path / "cache"
        assert fetch.resolve_checkpoint(url) == path and hits == ["/ckpt/matcha_tone.ckpt"]
        sd, hyper = tconvert.load_torch_checkpoint(url)
        assert hyper["decoder"]["channels"] == [96, 96] and "mel_mean" in sd
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()
