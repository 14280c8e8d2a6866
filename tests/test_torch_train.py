"""The port's training path against the JAX package, in fp32 on the CPU.

* features: the Slaney filterbank (equal) and the log-mel (atol 1e-4 on log
  values of order 10);
* `matcha_losses` with `train=False` on the same weights and batch, the CFM
  noise replayed from JAX's key schedule and injected: the four losses
  (rtol 1e-4) and every gradient leaf against `jax.grad` (rtol 1e-3,
  atol 2e-5: fp32 sums in another order through two dozen layers);
* one `train_step` against optax `clip_by_global_norm` + `adam` applied to
  the same gradients (rtol 1e-5, atol 1e-7), with and without clipping;
* the data pipeline: `BucketBatcher` batches equal to the JAX package's on a
  sine corpus, their features (atol 5e-3, see the test) and the mel
  statistics (atol 1e-4);
* the loop: two steps through the CLI, a checkpoint, a resume; best-k
  retention; graceful shutdown; dropout only with a generator.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.data.dataset import BucketBatcher as JBucketBatcher
from matcha_tts_tpu.data.dataset import TextMelDataset as JTextMelDataset
from matcha_tts_tpu.data.dataset import create_filelists as jcreate_filelists
from matcha_tts_tpu.models.matcha import init_matcha
from matcha_tts_tpu.train.losses import matcha_losses as jmatcha_losses
from matcha_tts_tpu.utils.wav import write_wav
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.data.dataset import BucketBatcher, TextMelDataset
from matcha_tts_tpu_torch.params.from_jax import copy_jax_tree, load_jax_tree, to_jax_tree
from matcha_tts_tpu_torch.train.losses import matcha_losses
from port_params import numpy_tree

ATOL_MEL = 1e-4
ATOL_SINE_MEL = 5e-3  # normalised log-mel of pure sines (see the test)


def small_config(**dec):
    return jcfg.MatchaConfig(
        encoder=jcfg.EncoderConfig(n_feats=80, n_channels=32, filter_channels=64, n_heads=2,
                                   n_layers=1),
        duration_predictor=jcfg.DurationPredictorConfig(filter_channels_dp=32),
        decoder=jcfg.DecoderConfig(channels=(32, 32), attention_head_dim=16, num_heads=2,
                                   num_mid_blocks=1, **dec))


def port_config(jc):
    return tcfg.config_from_dict(getattr(tcfg, type(jc).__name__), jcfg.config_to_dict(jc))


@functools.lru_cache(maxsize=1)
def jax_params():
    cfg = small_config()
    return numpy_tree(lambda key: init_matcha(key, cfg), 3,
                      fixed={"mel_mean": cfg.audio.mel_mean, "mel_std": cfg.audio.mel_std})


def port_model(cfg):
    model, _ = load_jax_tree({"matcha": jax_params()}, port_config(cfg), device="cpu")
    return model


def _batch(seed=0, b=2, t_x=16, t_y=48):
    rng = np.random.default_rng(seed)
    x_lengths = np.array([t_x, t_x - 5])[:b]
    y_lengths = np.array([t_y, t_y - 13])[:b]
    x = np.zeros((b, t_x), np.int64)
    for i, n in enumerate(x_lengths):
        x[i, :n] = rng.integers(1, 178, n)
    y = rng.standard_normal((b, t_y, 80)).astype(np.float32)
    return x, x_lengths, y, y_lengths


# ---------------------------------------------------------------------------
# features
# ---------------------------------------------------------------------------


def test_log_mel_and_filterbank_match_jax():
    from matcha_tts_tpu.ops.mel import mel_filterbank as jfb
    from matcha_tts_tpu.ops.stft import log_mel_spectrogram as jlog_mel
    from matcha_tts_tpu_torch.ops.mel import mel_filterbank
    from matcha_tts_tpu_torch.ops.stft import log_mel_spectrogram

    np.testing.assert_array_equal(mel_filterbank(22050, 1024, 80, 0.0, 8000.0),
                                  jfb(22050, 1024, 80, 0.0, 8000.0))
    audio = (0.3 * np.random.default_rng(1).standard_normal((2, 256 * 37 + 11))).astype(np.float32)
    ref = np.asarray(jlog_mel(jnp.asarray(audio)))
    got = log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape == (2, 80, 37)
    np.testing.assert_allclose(got, ref, atol=ATOL_MEL)


def test_log_mel_ignores_fp32_matmul_precision():
    """The filterbank product cannot be lowered by a process-wide fp32
    matmul setting: bf16 through oneDNN on the CPU (`medium`) would move the
    log-mel by up to 5e-3."""
    from matcha_tts_tpu_torch.ops.stft import log_mel_spectrogram

    audio = torch.from_numpy((0.3 * np.random.default_rng(2).standard_normal((2, 256 * 20)))
                             .astype(np.float32))
    want = log_mel_spectrogram(audio)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = log_mel_spectrogram(audio)
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------


def test_matcha_losses_and_gradients_match_jax():
    cfg = small_config()
    params = jax_params()
    x, x_lengths, y, y_lengths = _batch()
    key = jax.random.PRNGKey(7)
    # JAX's key schedule: matcha_losses splits (k_drop, k_cfm), compute_loss
    # splits k_cfm into (kt, kz)
    _, k_cfm = jax.random.split(key)
    kt, kz = jax.random.split(k_cfm)
    t = np.array(jax.random.uniform(kt, (2, 1, 1), jnp.float32))
    z = np.array(jax.random.normal(kz, y.shape, jnp.float32))

    def jloss(p):
        out = jmatcha_losses(p, key, jnp.asarray(x), jnp.asarray(x_lengths), jnp.asarray(y),
                             jnp.asarray(y_lengths), cfg, train=False)
        return out.total, out

    jgrads, jout = jax.grad(jloss, has_aux=True)(params)
    model = port_model(cfg)
    out = matcha_losses(model, torch.from_numpy(x), torch.from_numpy(x_lengths),
                        torch.from_numpy(y), torch.from_numpy(y_lengths), port_config(cfg),
                        train=False, t=torch.from_numpy(t), z=torch.from_numpy(z))
    for name in ("total", "dur_loss", "prior_loss", "cfm_loss"):
        np.testing.assert_allclose(getattr(out, name).item(), float(getattr(jout, name)),
                                   rtol=1e-4, err_msg=name)
    out.total.backward()
    tg = to_jax_tree(model, grads=True)
    paths = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(paths) == len(jax.tree_util.tree_leaves(tg))
    for path, want in paths:
        node = tg
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_allclose(node, np.asarray(want), rtol=1e-3, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_dropout_needs_a_generator():
    from matcha_tts_tpu_torch.models.nn import dropout

    x = torch.ones(4, 1000)
    assert dropout(x, 0.3, None) is x
    a = dropout(x, 0.3, torch.Generator().manual_seed(0))
    b = dropout(x, 0.3, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.6 < float(kept.float().mean()) < 0.8
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))


def test_train_forward_is_stochastic_only_with_a_generator():
    """Dropout changes the loss only when the train forward has a generator;
    the duration predictor reads a detached encoder output."""
    cfg = small_config()
    model = port_model(cfg)
    x, x_lengths, y, y_lengths = (torch.from_numpy(a) for a in _batch(1))
    args = (model, x, x_lengths, y, y_lengths, port_config(cfg))
    t, z = torch.full((2,), 0.5), torch.zeros_like(y)
    eval_a = matcha_losses(*args, train=False, t=t, z=z).total
    eval_b = matcha_losses(*args, train=True, t=t, z=z).total  # no generator: no dropout
    train = matcha_losses(*args, generator=torch.Generator().manual_seed(0), t=t, z=z).total
    assert eval_a.item() == eval_b.item() and train.item() != eval_a.item()
    out = matcha_losses(*args, train=False, t=t, z=z)
    out.dur_loss.backward()
    assert model.encoder.encoder.layers[0].attn.conv_q.weight.grad is None
    assert model.encoder.proj_w.conv_1.weight.grad is not None


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [5.0, 0.05])
def test_train_step_matches_optax(clip):
    """One `train_step` (fp32, dropout rates 0) against optax applied to the
    gradients of the same loss: the pre-clip norm and the updated weights."""
    from matcha_tts_tpu_torch.models.cfm import row_seed
    from matcha_tts_tpu_torch.train.train_state import create_train_state, train_step

    base = small_config()
    cfg = dataclasses.replace(
        base, encoder=dataclasses.replace(base.encoder, p_dropout=0.0, prenet=False),
        duration_predictor=dataclasses.replace(base.duration_predictor, p_dropout=0.0),
        decoder=dataclasses.replace(base.decoder, dropout=0.0))
    pcfg = port_config(cfg)
    train_cfg = tcfg.TrainConfig(learning_rate=1e-3, grad_clip_norm=clip,
                                 mixed_precision=False, seed=5)
    params = numpy_tree(lambda key: init_matcha(key, cfg), 4,
                        fixed={"mel_mean": cfg.audio.mel_mean, "mel_std": cfg.audio.mel_std})
    x, x_lengths, y, y_lengths = (torch.from_numpy(a) for a in _batch(2))
    batch = {"x": x, "x_lengths": x_lengths, "y": y, "y_lengths": y_lengths}

    # the gradients train_step will see: the same generator, drawn in order
    ref_model, _ = load_jax_tree({"matcha": params}, pcfg, device="cpu")
    g = torch.Generator().manual_seed(row_seed(train_cfg.seed, 0))
    matcha_losses(ref_model, x, x_lengths, y, y_lengths, pcfg, generator=g).total.backward()
    grads = to_jax_tree(ref_model, grads=True)
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adam(train_cfg.learning_rate))
    jparams = to_jax_tree(ref_model)
    updates, _ = tx.update(grads, tx.init(jparams), jparams)
    want = optax.apply_updates(jparams, updates)

    model, _ = load_jax_tree({"matcha": params}, pcfg, device="cpu")
    state = create_train_state(model, train_cfg)
    metrics = train_step(state, batch, pcfg, train_cfg)
    assert state.step == 1
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(grads)),
                               rtol=1e-5)
    if clip < 1.0:
        assert float(metrics["grad_norm"]) > clip  # the clip branch was taken
    got = to_jax_tree(model)
    for (path, w), g_ in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                             jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(g_, np.asarray(w), rtol=1e-5, atol=1e-7,
                                   err_msg=jax.tree_util.keystr(path))


def test_to_jax_tree_round_trips():
    cfg = small_config()
    model = port_model(cfg)
    tree = to_jax_tree(model)
    shapes = jax.tree_util.tree_map(lambda a: a.shape, jax_params())
    assert jax.tree_util.tree_map(lambda a: a.shape, tree) == shapes
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(jax_params())):
        np.testing.assert_array_equal(a, b)
    again = copy_jax_tree(port_model(cfg), tree)
    for name, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[name]), name


# ---------------------------------------------------------------------------
# data and loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sine_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ljs")
    (root / "wavs").mkdir()
    rng = np.random.default_rng(0)
    texts = ["hello world", "this is a test", "matcha tts on tpu", "four score and seven",
             "the quick brown fox", "jumps over dogs", "alpha beta gamma", "delta epsilon zeta"]
    lines = []
    for i, text in enumerate(texts):
        t = np.arange(int(22050 * rng.uniform(0.4, 0.9))) / 22050
        write_wav(root / "wavs" / f"utt{i}.wav",
                  (0.3 * np.sin(2 * np.pi * (120 + 30 * i) * t)).astype(np.float32), 22050)
        lines.append(f"utt{i}|{text}|{text}")
    (root / "metadata.csv").write_text("\n".join(lines) + "\n")
    return root


def test_bucket_batches_and_features_match_jax(sine_corpus):
    from matcha_tts_tpu.train.loop import featurize_batch as jfeaturize
    from matcha_tts_tpu_torch.data.dataset import create_filelists
    from matcha_tts_tpu_torch.train.loop import featurize_batch

    train_fl, _ = create_filelists(sine_corpus, val_fraction=0.25)
    jtrain_fl, _ = jcreate_filelists(sine_corpus, val_fraction=0.25)
    assert open(train_fl).read() == open(jtrain_fl).read()
    kw = dict(batch_size=3, text_buckets=(32, 64), frame_buckets=(64, 128, 256))
    ds = TextMelDataset(train_fl, tcfg.AudioConfig(), seed=1)
    jds = JTextMelDataset(jtrain_fl, jcfg.AudioConfig(), seed=1)
    got = list(BucketBatcher(ds, tcfg.TrainConfig(**kw), shuffle=True, seed=3))
    want = list(JBucketBatcher(jds, jcfg.TrainConfig(**kw), shuffle=True, seed=3))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    cfg = small_config()
    feat = featurize_batch(got[0], port_config(cfg), "cpu")
    ref = jfeaturize(want[0], cfg)
    # pure sines leave most bins near the 1e-5 floor, where fp32 FFT round-off
    # between the two libraries (1e-7 of the peak) grows to 1e-3 in the log
    np.testing.assert_allclose(feat["y"].numpy(), np.asarray(ref["y"]), atol=ATOL_SINE_MEL)


def test_mel_statistics_match_jax(sine_corpus):
    from matcha_tts_tpu.data.statistics import compute_mel_statistics as jstats
    from matcha_tts_tpu_torch.data.dataset import create_filelists
    from matcha_tts_tpu_torch.data.statistics import compute_mel_statistics

    train_fl, _ = create_filelists(sine_corpus, val_fraction=0.25)
    got = compute_mel_statistics(train_fl, tcfg.AudioConfig(), batch_size=3,
                                 frame_buckets=(32, 64, 128), device="cpu")
    want = jstats(train_fl, jcfg.AudioConfig(), batch_size=3, frame_buckets=(32, 64, 128))
    np.testing.assert_allclose(got, want, atol=ATOL_MEL)


def test_cli_fits_two_steps_saves_and_resumes(sine_corpus, tmp_path):
    """`--device cpu --debug_tiny`: two steps, a checkpoint, then a resume that
    continues from step 2."""
    import json

    from matcha_tts_tpu_torch.train import cli

    work = tmp_path / "run"
    argv = ["--data_root", str(sine_corpus), "--device", "cpu", "--debug_tiny",
            "--batch_size", "2", "--work_dir", str(work)]
    state = cli.main(argv + ["--max_steps", "2"])
    assert state.step == 2
    assert sorted(p.name for p in (work / "ckpt").glob("*.pt")) == ["step_00000002.pt"]
    recs = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    assert recs[-1]["split"] == "val" and np.isfinite(recs[-1]["loss"])
    w = dict(state.model.named_parameters())["decoder.estimator.final_proj.weight"].detach().clone()
    state2 = cli.main(argv + ["--max_steps", "3"])
    assert state2.step == 3
    assert state2.optimizer.state_dict()["state"][0]["step"] == 3
    w2 = dict(state2.model.named_parameters())["decoder.estimator.final_proj.weight"]
    assert not torch.equal(w, w2.detach())


def test_checkpointer_keeps_best_by_val_loss(tmp_path):
    """The `keep` best by val loss survive plus the latest; the ranking
    survives a restart; resume takes the latest."""
    from matcha_tts_tpu_torch.models.matcha import MatchaTTS
    from matcha_tts_tpu_torch.train.loop import Checkpointer
    from matcha_tts_tpu_torch.train.train_state import create_train_state

    cfg = port_config(small_config())
    state = create_train_state(MatchaTTS(cfg, device="cpu"), tcfg.TrainConfig())
    ck = Checkpointer(tmp_path / "best", keep=2)
    for step, loss in {1: 5.0, 2: 1.0, 3: 4.0, 4: 0.5, 5: 3.0}.items():
        state.step = step
        ck.save(step, state, cfg, metrics={"loss": loss})
    assert ck.all_steps() == [2, 4, 5]
    assert sorted(p.name for p in (tmp_path / "best").glob("*.pt")) == [
        "step_00000002.pt", "step_00000004.pt", "step_00000005.pt"]
    ck2 = Checkpointer(tmp_path / "best", keep=2)
    state.step = 6
    ck2.save(6, state, cfg, metrics={"loss": 2.0})
    assert ck2.all_steps() == [2, 4, 6]
    assert ck2.restore(state).step == 6
    assert ck2.restore(state, step=4).step == 4


def test_graceful_shutdown_sets_the_flag_and_restores_handlers():
    """A SIGTERM sets `.requested` without stopping the process, a second one
    raises KeyboardInterrupt, and leaving the context restores the handlers."""
    import os
    import signal
    import time

    from matcha_tts_tpu_torch.train.loop import GracefulShutdown

    before = signal.getsignal(signal.SIGTERM)
    with GracefulShutdown() as sd:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5.0
        while not sd.requested and time.time() < deadline:
            time.sleep(0.01)
        assert sd.requested
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.time() + 5.0
            while time.time() < deadline:  # the handler raises between bytecodes
                time.sleep(0.01)
    assert signal.getsignal(signal.SIGTERM) is before


def test_prefetch_iterator_reraises():
    from matcha_tts_tpu_torch.data.dataset import PrefetchIterator

    assert list(PrefetchIterator(iter(range(7)), depth=2)) == list(range(7))

    def boom():
        yield 1
        raise RuntimeError("io error")

    it = PrefetchIterator(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError):
        next(it)
