"""The port's evaluation package (`matcha_tts_tpu_torch/eval/`) against the JAX
package's on the CPU: the WER plumbing (WER, normalisation, `resample`,
`evaluate_wer`: equal values), the CTC judge's logits at full
`CTCASRConfig()` width on ragged mels (max |diff| <= 1e-4 of the logits'
scale), its loss and gradients (relative 1e-4, feasible alignments only:
optax clamps an infeasible one where torch gives inf), the committed
3-member judge on the goldens' 12 held-out mels (the same transcripts), the
`.npz` round trip in both directions, the medoid vote, a toy task learnt to
an exact decode, the judge through `wav_asr_callable` on rendered audio, and
the trained `matcha_tone.ckpt` through the port's `load_models`,
synthesised and judged: held-out WER within the JAX test's bound
(`tests/test_trained_artifact.py`)."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tts_tpu.eval import ctc_asr as jasr
from matcha_tts_tpu.eval import wer as jwer
from matcha_tts_tpu_torch.eval import ctc_asr as tasr
from matcha_tts_tpu_torch.eval import wer as twer
from matcha_tts_tpu_torch.params.from_jax import copy_jax_tree, flatten_tree, to_jax_tree
from port_params import numpy_tree

ART = Path(__file__).resolve().parent / "golden" / "trained"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg, seed):
    """A numpy-drawn JAX tree and the port's CTCASR holding it."""
    tree = numpy_tree(lambda key: jasr.init_ctc_asr(key, cfg), seed)
    return tree, copy_jax_tree(tasr.CTCASR(cfg, device="cpu"), tree)


def _ragged_mels(rng, b, t, n_mels, lengths):
    return rng.standard_normal((b, t, n_mels)).astype(np.float32) - 5.0, np.asarray(lengths,
                                                                                   np.int32)


def test_wer_plumbing_matches_jax():
    pairs = [("the cat sat", "the cat sat"), ("the cat sat", "a cat sat down"),
             ("", "words"), ("One two, three!", "one TWO three")]
    for ref, hyp in pairs:
        assert twer.word_error_rate(ref, hyp) == jwer.word_error_rate(ref, hyp)
    for text in ("Hello, World! It's 3 o'clock.", "  spaced   out\ttext "):
        assert twer.normalize_for_wer(text) == jwer.normalize_for_wer(text)
    wav = np.random.default_rng(0).standard_normal(22050 // 3).astype(np.float32)
    for sr_in, sr_out in ((22050, 16000), (16000, 22050), (22050, 22050)):
        got, want = twer.resample(wav, sr_in, sr_out), jwer.resample(wav, sr_in, sr_out)
        assert got.dtype == np.float32 and len(got) == int(len(wav) * sr_out / sr_in)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(twer.resample_to_16k(wav, 22050),
                                  jwer.resample_to_16k(wav, 22050))
    asr = lambda w: "the cat" if len(w) > 3000 else "dog"  # noqa: E731
    wavs = [wav, wav[:1000]]
    assert (twer.evaluate_wer(["The cat.", "A dog"], wavs, 22050, asr)
            == jwer.evaluate_wer(["The cat.", "A dog"], wavs, 22050, asr))


def test_codec_and_vote():
    text = "the quick brown fox jumps over the lazy dog"
    assert tasr.decode_chars(tasr.encode_chars(text)) == text
    np.testing.assert_array_equal(tasr.encode_chars("Hello, World! 123"),
                                  jasr.encode_chars("Hello, World! 123"))
    hyps = [["the fox", "a dog", "ab"], ["the fox", "a ddog", "cd"], ["the ffox", "a dog", "ef"]]
    assert tasr.vote_hypotheses(hyps) == jasr.vote_hypotheses(hyps) == ["the fox", "a dog", "ab"]
    logits = np.zeros((1, 6, tasr.VOCAB_SIZE), np.float32)
    for t, c in enumerate([1, 1, 0, 1, 27, 2]):
        logits[0, t, c] = 1.0
    assert tasr.greedy_decode(logits, [6]) == jasr.greedy_decode(logits, np.array([6])) == ["aa b"]


def test_ctc_logits_full_width_match_jax():
    """Every output frame whose receptive field lies inside the valid input
    frames, within 1e-4 of the logits' scale.  A padding frame is a constant
    row (MEL_PAD_VALUE), and the input LayerNorm divides the rounding error
    of its mean by sqrt(1e-5): each package's summation order gives other
    values there, and frames within the receptive radius (16 frames after
    the stride-2 stem, 2 in it) of the padding inherit the difference.
    What the padding holds before the mask does not matter (bit for bit)."""
    cfg = jasr.CTCASRConfig()
    tree, model = _pair(cfg, 0)
    lengths_list = (96, 57, 1)
    mel, lengths = _ragged_mels(np.random.default_rng(1), 3, 96, cfg.n_mels, lengths_list)
    want = np.asarray(jasr.ctc_logits(tree, jnp.asarray(mel), jnp.asarray(lengths), cfg))
    with torch.no_grad():
        got = tasr.ctc_logits(model, torch.from_numpy(mel), torch.from_numpy(lengths)).numpy()
        junk = mel.copy()
        junk[1, 57:] = 1e3
        junk[2, 1:] = -1e3
        np.testing.assert_array_equal(
            tasr.ctc_logits(model, torch.from_numpy(junk), torch.from_numpy(lengths)).numpy(),
            got)
    assert got.shape == want.shape == (3, 48, cfg.vocab_size)
    radius = 2 * sum(cfg.dilations) * cfg.stride + (cfg.kernel - 1) // 2  # in input frames
    scale = np.abs(want).max()
    checked = 0
    for row, n in enumerate(lengths_list):
        for j in range(want.shape[1]):
            if n == want.shape[1] * cfg.stride or cfg.stride * j + radius < n:
                assert np.abs(got[row, j] - want[row, j]).max() <= 1e-4 * scale, (row, j)
                checked += 1
    assert checked > 48 + 5
    np.testing.assert_array_equal(
        tasr.out_lengths(torch.from_numpy(lengths), cfg).numpy(),
        np.asarray(jasr.out_lengths(jnp.asarray(lengths), cfg)))


@pytest.mark.parametrize("mel_lengths,grad_rel", [((40, 40, 40), 1e-4), ((40, 33, 26), 1e-3)],
                         ids=["full", "ragged"])
def test_ctc_loss_and_gradients_match_jax(mel_lengths, grad_rel):
    """The loss within relative 1e-4, each gradient leaf within relative L2
    `grad_rel`: 1e-4 where every mel frame is valid; with padding, the
    constant padding rows' LayerNorm (see the logits test) reaches the
    gradients of the frames beside them, and the bound is 1e-3."""
    cfg = jasr.CTCASRConfig(hidden=48, dilations=(1, 2))
    tree, model = _pair(cfg, 2)
    mel, lengths = _ragged_mels(np.random.default_rng(3), 3, 40, cfg.n_mels, mel_lengths)
    # feasible: at most 8 labels, a blank between repeats, in >= 13 frames
    labels = np.array([[1, 1, 2, 27, 3, 3, 4, 5], [7, 8, 9, 0, 0, 0, 0, 0],
                       [26, 26, 26, 1, 0, 0, 0, 0]], np.int32)
    label_lengths = np.array([8, 3, 4], np.int32)
    loss, grads = jax.jit(jax.value_and_grad(jasr.ctc_asr_loss), static_argnums=5)(
        tree, jnp.asarray(mel), jnp.asarray(lengths), jnp.asarray(labels),
        jnp.asarray(label_lengths), cfg)
    tloss = tasr.ctc_asr_loss(model, torch.from_numpy(mel), torch.from_numpy(lengths),
                              torch.from_numpy(labels), torch.from_numpy(label_lengths))
    tloss.backward()
    assert abs(tloss.item() - float(loss)) <= 1e-4 * abs(float(loss))
    got, want = flatten_tree(to_jax_tree(model, grads=True)), flatten_tree(grads)
    assert got.keys() == want.keys()
    for k in want:
        err = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert err <= grad_rel, (k, err)


@functools.lru_cache(maxsize=1)
def _goldens():
    g = dict(np.load(ART / "goldens.npz"))
    mel = g["mel"].transpose(0, 2, 1).copy()
    for i, n in enumerate(g["y_lengths"]):
        mel[i, n:] = jasr.MEL_PAD_VALUE
    return g, mel


def test_committed_judge_transcribes_goldens_like_jax():
    g, mel = _goldens()
    jparams, jcfg = jasr.load_ctc_asr(ART / "ctc_judge.npz")
    judge, cfg = tasr.load_ctc_asr(ART / "ctc_judge.npz", device="cpu")
    assert isinstance(judge, list) and len(judge) == 3
    assert cfg == tasr.CTCASRConfig(**{**jcfg.__dict__})
    want = jasr.transcribe_mels(jparams, mel, g["y_lengths"], jcfg)
    got = tasr.transcribe_mels(judge, mel, g["y_lengths"])
    assert got == want
    assert got == [str(t) for t in g["texts"]]  # the recorded WER is 0


def test_save_load_round_trip_between_packages(tmp_path):
    cfg = jasr.CTCASRConfig(n_mels=8, hidden=16, dilations=(1, 2))
    tree, model = _pair(cfg, 4)
    # the port's file, read by the JAX package
    tasr.save_ctc_asr(tmp_path / "port.npz", model)
    back, back_cfg = jasr.load_ctc_asr(tmp_path / "port.npz")
    assert back_cfg == cfg
    want = flatten_tree(tree)
    for k, v in flatten_tree(back).items():
        np.testing.assert_array_equal(np.asarray(v), want[k], err_msg=k)
    # the JAX package's ensemble file, read by the port
    jasr.save_ctc_asr(tmp_path / "jax.npz", [tree, tree], cfg)
    members, tcfg = tasr.load_ctc_asr(tmp_path / "jax.npz", device="cpu")
    assert tcfg.dilations == (1, 2) and len(members) == 2
    for m in members:
        got = flatten_tree(to_jax_tree(m))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and the port's ensemble file back into the port
    tasr.save_ctc_asr(tmp_path / "ens.npz", members)
    again, _ = tasr.load_ctc_asr(tmp_path / "ens.npz", device="cpu")
    assert len(again) == 2


def test_toy_task_learnt_to_exact_decode():
    from benchmarks.wer_e2e import pack_labels

    cfg = tasr.CTCASRConfig(n_mels=8, hidden=32, dilations=(1, 2))
    texts = ["abc", "cab", "bca", "cba", "bac", "acb", "bab", "cbc"]
    seg = 6
    mels, mlens = [], []
    for text in texts:
        m = np.full((32, 8), tasr.MEL_PAD_VALUE, np.float32)
        pos = 0
        for ch in text:
            k = ord(ch) - ord("a")
            pat = np.full((seg, 8), -8.0, np.float32)
            pat[:, 2 * k:2 * k + 2] = -1.0
            m[pos:pos + seg] = pat
            pos += seg + 1
        mels.append(m)
        mlens.append(pos - 1)
    mels, mlens = np.stack(mels), np.asarray(mlens, np.int32)
    labels, llens = pack_labels(texts)
    model = tasr.train_ctc_asr(mels, mlens, labels, llens, cfg, steps=300, lr=3e-3,
                               seed=0, device="cpu")
    assert tasr.transcribe_mels(model, mels, mlens) == texts


def test_judge_on_rendered_audio_like_jax():
    """`wav_asr_callable` (16 kHz in, the judge's log-mel, CTC decode) on
    tone-corpus audio of a held-out text, through `evaluate_wer`."""
    from benchmarks.tone_corpus import HELD_OUT_TEXTS, SR, max_frames, render_text
    from matcha_tts_tpu.config import AudioConfig

    text = HELD_OUT_TEXTS[0]
    bucket = max(128, int(max_frames([text]) * 1.12) + 2)
    wav = render_text(text, np.random.default_rng(4))
    jparams, jcfg = jasr.load_ctc_asr(ART / "ctc_judge.npz")
    judge, _ = tasr.load_ctc_asr(ART / "ctc_judge.npz", device="cpu")
    from matcha_tts_tpu_torch.config import AudioConfig as TAudio

    want = jwer.evaluate_wer([text], [wav], SR,
                             jasr.wav_asr_callable(jparams, jcfg, AudioConfig(), bucket))
    got = twer.evaluate_wer([text], [wav], SR, tasr.wav_asr_callable(judge, TAudio(), bucket))
    assert got["hypotheses"] == want["hypotheses"]
    assert got["mean_wer"] == want["mean_wer"] == 0.0


def test_trained_checkpoint_is_intelligible_through_the_port():
    """matcha_tone.ckpt through the port's `load_models`, the goldens' 12
    held-out texts at their buckets, NFE and temperature (the port's own
    noise), judged by the committed ensemble: mean WER within the JAX
    test's bound, recorded + 0.15."""
    from matcha_tts_tpu_torch.inference.cli import load_models
    from matcha_tts_tpu_torch.text.tokenizer import encode_text

    g, _ = _goldens()
    model, _, _, _ = load_models(checkpoint=str(ART / "matcha_tone.ckpt"), device="cpu")
    texts = [str(t) for t in g["texts"]]
    tb, fb = int(g["text_bucket"]), int(g["frame_bucket"])
    x = torch.zeros((len(texts), tb), dtype=torch.long)
    x_lengths = torch.ones((len(texts),), dtype=torch.long)
    for r, t in enumerate(texts):
        ids = encode_text(t, add_blank=True)[:tb]
        x[r, :len(ids)] = torch.as_tensor(ids)
        x_lengths[r] = len(ids)
    with torch.no_grad():
        out = model.synthesize(x, x_lengths, n_timesteps=int(g["nfe"]), t_y_max=fb,
                               temperature=float(g["temperature"]), seed=7)
    mel = out.mel.transpose(1, 2).contiguous()
    lengths = out.y_lengths
    for i, n in enumerate(lengths.tolist()):
        mel[i, n:] = tasr.MEL_PAD_VALUE
    judge, _ = tasr.load_ctc_asr(ART / "ctc_judge.npz", device="cpu")
    hyps = tasr.transcribe_mels(judge, mel, lengths)
    wer = float(np.mean([twer.word_error_rate(twer.normalize_for_wer(t),
                                              twer.normalize_for_wer(h))
                         for t, h in zip(texts, hyps)]))
    assert wer <= float(g["wer_synth_heldout"]) + 0.15, (wer, hyps)
