"""The port's vocoder GAN training (`train/vocoder.py`, `train/weight_norm.py`,
`train/vocoder_cli.py`, the discriminators in `models/hifigan.py` and
`models/vocos.py`) against the JAX package on the CPU.

The JAX package's tiny generator configurations of its own GAN tests (hop
16, 8 mels) with the full-width discriminators, unit-gain numpy weights,
one 2048-sample segment:

* MPD, MSD and MRD logits and feature maps, and the three GAN losses;
* one discriminator step and one generator step from the same trees, for
  HiFi-GAN with MPD + MSD and Vocos with MPD + MRD, plain and in (v, g)
  weight-norm form: losses within relative 1e-5; the discriminators'
  gradient within relative L2 1e-4 at every leaf; the generator's, over the
  whole tree, within the larger of 1e-4 and 3x the change that a 1e-7
  relative change of the audio makes to the port's own (the L1 and
  LeakyReLU kinks make it that sensitive: about 1e-4 for HiFi-GAN); the
  JAX step's gradient is read from its Adam state (mu = (1 - b1) g after
  the first update); the parameters after Adam's first step within 2 lr
  (a gradient near zero may take either sign);
* the learning rate at updates 0, 1000 and 2500 against optax's schedule;
  a step with non-finite gradients skipped under grad_clip, and taken after
  32 such steps in a row, as optax's `apply_if_finite`;
* weight norm's round trip and its (v, g) against the JAX package's;
* a checkpoint restored into a fresh state resumes bit for bit;
* `vocoder_cli --debug_tiny` for 2 steps on a corpus synthesised from a
  seed, a resume, the `gan_meta.json` refusal, and a step under
  `--data_parallel` in a world of one.
"""

import copy
import functools
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from matcha_tts_tpu import config as jc
from matcha_tts_tpu.models import hifigan as jhifigan
from matcha_tts_tpu.models import vocos as jvocos
from matcha_tts_tpu.train import vocoder as jtrain
from matcha_tts_tpu.train import weight_norm as jwn
from matcha_tts_tpu_torch import config as tc
from matcha_tts_tpu_torch.models import hifigan as thifigan
from matcha_tts_tpu_torch.params.from_jax import (copy_jax_tree, flatten_tree, load_jax_tree,
                                                  to_jax_tree)
from matcha_tts_tpu_torch.train import vocoder as ttrain
from matcha_tts_tpu_torch.train import weight_norm as twn
from port_params import numpy_tree

HCFG = jc.HiFiGANConfig(upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
                        upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                        resblock_dilation_sizes=((1, 3),), num_mels=8)
VCFG = jc.VocosConfig(num_mels=8, dim=32, intermediate_dim=64, num_layers=2, n_fft=64,
                      hop_length=16)
ACFG = jc.AudioConfig(n_mels=8, n_fft=256, win_length=256, hop_length=16, f_max=4000.0)
LR = 2e-4
DISC_INIT = {"mpd": jhifigan.init_mpd, "msd": jhifigan.init_msd, "mrd": jvocos.init_mrd}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(cfg):
    cls = tc.VocosConfig if isinstance(cfg, jc.VocosConfig) else tc.HiFiGANConfig
    return tc.config_from_dict(cls, jc.config_to_dict(cfg))


TA = tc.config_from_dict(tc.AudioConfig, jc.config_to_dict(ACFG))


@functools.lru_cache(maxsize=None)
def _disc_tree(name):
    return numpy_tree(DISC_INIT[name], {"mpd": 1, "msd": 2, "mrd": 3}[name])


def _audio(seed=1, b=1, n=2048):
    return (np.random.default_rng(seed).standard_normal((b, n)) * 0.1).astype(np.float32)


def _port_discs(names):
    discs = torch.nn.ModuleDict({n: ttrain.DISCRIMINATORS[n](device="cpu") for n in names})
    return copy_jax_tree(discs, {n: _disc_tree(n) for n in names})


def _close(got, want, rel, what):
    """Every leaf within relative L2 `rel`."""
    assert got.keys() == want.keys()
    for k in want:
        err = np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), 1e-30)
        assert err <= rel, (what, k, err)


def _tree_rel(got, want) -> float:
    """Relative L2 over a whole tree."""
    num = sum(np.sum((got[k] - np.asarray(want[k])) ** 2) for k in want)
    return float(np.sqrt(num / sum(np.sum(np.asarray(want[k]) ** 2) for k in want)))


@pytest.mark.parametrize("name", ["mpd", "msd", "mrd"])
def test_discriminators_match_jax(name):
    y, y_hat = _audio(2, 2, 2048), _audio(3, 2, 2048)
    tree = _disc_tree(name)
    jfwd = {"mpd": jhifigan.mpd, "msd": jhifigan.msd, "mrd": jvocos.mrd}[name]
    want = jax.jit(jfwd)(tree, jnp.asarray(y), jnp.asarray(y_hat))
    disc = _port_discs([name])[name]
    with torch.no_grad():
        got = disc(torch.from_numpy(y), torch.from_numpy(y_hat))
    for gl, wl in zip(got[:2], want[:2]):
        for g, w in zip(gl, wl):
            assert g.shape == w.shape
            assert np.linalg.norm(g.numpy() - np.asarray(w)) <= 1e-5 * np.linalg.norm(w)
    for gf, wf in zip(got[2] + got[3], want[2] + want[3]):
        for g, w in zip(gf, wf):
            assert g.shape == w.shape
            assert np.linalg.norm(g.numpy() - np.asarray(w)) <= 1e-5 * np.linalg.norm(w)
    # the losses on these outputs
    for tfn, jfn, args in ((thifigan.discriminator_loss, jhifigan.discriminator_loss,
                            (0, 1)),
                           (thifigan.generator_loss, jhifigan.generator_loss, (1,)),
                           (thifigan.feature_loss, jhifigan.feature_loss, (2, 3))):
        t_out = tfn(*[got[i] for i in args])
        j_out = jfn(*[want[i] for i in args])
        t_val = t_out[0] if isinstance(t_out, tuple) else t_out
        j_val = j_out[0] if isinstance(j_out, tuple) else j_out
        assert abs(float(t_val) - float(j_val)) <= 1e-5 * abs(float(j_val)), tfn.__name__


def _jax_state(gen_cfg, names, use_wn):
    gen_init = (functools.partial(jvocos.init_vocos, cfg=gen_cfg)
                if isinstance(gen_cfg, jc.VocosConfig)
                else functools.partial(jhifigan.init_generator, cfg=gen_cfg))
    gen = numpy_tree(lambda key: gen_init(key), 0)
    disc = {n: _disc_tree(n) for n in names}
    plain = (gen, disc)
    if use_wn:
        gen, disc = jwn.decompose(gen), jwn.decompose(disc)
    g_tx, d_tx = jtrain.make_gan_optimizers(LR)
    state = jtrain.GanTrainState(step=jnp.zeros((), jnp.int32), gen_params=gen,
                                 disc_params=disc, gen_opt=g_tx.init(gen),
                                 disc_opt=d_tx.init(disc))
    return state, plain


def _port_state(gen_cfg, names, plain, use_wn):
    _, gen = load_jax_tree({"vocoder": plain[0]}, tc.MatchaConfig(), _port_cfg(gen_cfg),
                           device="cpu")
    if not use_wn:  # a given generator, as for fine-tuning
        state = ttrain.create_gan_state(_port_cfg(gen_cfg), generator=gen, discriminators=names,
                                        device="cpu")
        copy_jax_tree(state.discriminators, {n: _disc_tree(n) for n in names})
        return state
    discs = _port_discs(names)
    twn.decompose(gen)
    twn.decompose(discs)
    g_opt, d_opt = ttrain.make_gan_optimizers(gen.parameters(), discs.parameters(), LR)
    return ttrain.GanTrainState(step=0, generator=gen, discriminators=discs, gen_opt=g_opt,
                                disc_opt=d_opt)


@pytest.mark.parametrize("family,use_wn", [("hifigan", False), ("hifigan", True),
                                           ("vocos", False), ("vocos", True)],
                         ids=["hifigan-mpd-msd", "hifigan-mpd-msd-wn", "vocos-mpd-mrd",
                              "vocos-mpd-mrd-wn"])
def test_gan_steps_match_jax(family, use_wn):
    gen_cfg, names = (HCFG, ("mpd", "msd")) if family == "hifigan" else (VCFG, ("mpd", "mrd"))
    jstate, plain = _jax_state(gen_cfg, names, use_wn)
    tstate = _port_state(gen_cfg, names, plain, use_wn)
    assert twn.is_weight_norm(tstate.generator) == use_wn == jwn.is_weight_norm(jstate.gen_params)
    audio = _audio()
    jaudio, taudio = jnp.asarray(audio), torch.from_numpy(audio)

    jstate, jloss = jtrain.gan_disc_step(jstate, jaudio, gen_cfg, ACFG, weight_norm=use_wn)
    tstate, tloss = ttrain.gan_disc_step(tstate, taudio, TA)
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jgrads = jax.tree.map(lambda m: np.asarray(m) / 0.2, jstate.disc_opt[0].mu)
    _close(flatten_tree(to_jax_tree(tstate.discriminators, grads=True)), flatten_tree(jgrads),
           1e-4, "disc grad")
    got, want = flatten_tree(to_jax_tree(tstate.discriminators)), flatten_tree(jstate.disc_params)
    assert got.keys() == want.keys()
    assert max(np.abs(got[k] - np.asarray(want[k])).max() for k in want) <= 2 * LR

    # the generator's gradient moves by ~1e-4 under a 1e-7 relative change
    # of the audio (the feature-matching L1 and the discriminators'
    # LeakyReLUs have kinks): measured here on the port, as a floor
    probe_gen = copy.deepcopy(tstate.generator)
    probe = ttrain.GanTrainState(0, probe_gen, tstate.discriminators,
                                 ttrain.GanOptimizer(probe_gen.parameters(), LR), tstate.disc_opt)
    ttrain.gan_gen_step(probe, taudio * (1 + 1e-7), TA)
    jstate, jm = jtrain.gan_gen_step(jstate, jaudio, gen_cfg, ACFG, weight_norm=use_wn)
    tstate, tm = ttrain.gan_gen_step(tstate, taudio, TA)
    for k in ("gen_loss", "mel_l1", "fm_loss"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    jgrads = flatten_tree(jax.tree.map(lambda m: np.asarray(m) / 0.2, jstate.gen_opt[0].mu))
    tgrads = flatten_tree(to_jax_tree(tstate.generator, grads=True))
    floor = _tree_rel(flatten_tree(to_jax_tree(probe.generator, grads=True)), tgrads)
    assert tgrads.keys() == jgrads.keys()
    assert _tree_rel(tgrads, jgrads) <= max(1e-4, 3 * floor), (_tree_rel(tgrads, jgrads), floor)
    got, want = flatten_tree(to_jax_tree(tstate.generator)), flatten_tree(jstate.gen_params)
    assert got.keys() == want.keys()
    assert max(np.abs(got[k] - np.asarray(want[k])).max() for k in want) <= 2 * LR
    assert tstate.step == int(jstate.step) == 1


def test_schedule_matches_optax():
    sched = optax.exponential_decay(LR, 1000, 0.999)
    opt = ttrain.GanOptimizer([torch.nn.Parameter(torch.zeros(1))], LR)
    for k in (0, 1000, 2500):
        opt.updates = k
        assert abs(opt.lr() - float(sched(k))) <= 1e-7 * LR, k


def test_non_finite_steps_are_skipped_under_grad_clip():
    """A NaN gradient leaves the parameters, Adam's moments and the
    schedule's count; the 33rd in a row is applied, as in optax (checked on
    optax's own chain)."""
    p = torch.nn.Parameter(torch.ones(3))
    opt = ttrain.GanOptimizer([p], LR, grad_clip=1.0)
    tx, _ = jtrain.make_gan_optimizers(LR, grad_clip=1.0)
    jp = jnp.ones(3)
    jst = tx.init(jp)
    update = jax.jit(tx.update)

    def step(g):
        nonlocal jp, jst
        p.grad = torch.tensor(g, dtype=torch.float32)
        applied = opt.step()
        upd, jst = update(jnp.asarray(g, jnp.float32), jst, jp)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-7)
        return applied

    assert step([3.0, -4.0, 0.0])  # clipped to norm 1, then Adam
    before = (p.detach().clone(), opt.adam.state[p]["exp_avg"].clone(), opt.updates)
    for _ in range(ttrain.MAX_CONSECUTIVE_ERRORS):
        assert not step([float("nan"), 1.0, 1.0])
    assert torch.equal(p.detach(), before[0]) and opt.updates == before[2] == 1
    assert torch.equal(opt.adam.state[p]["exp_avg"], before[1])
    assert step([float("nan"), 1.0, 1.0])  # the 33rd in a row goes through
    assert torch.isnan(p.detach()).any()


def test_weight_norm_round_trip_matches_jax():
    tree = numpy_tree(lambda key: jhifigan.init_generator(key, HCFG), 0)
    _, gen = load_jax_tree({"vocoder": tree}, tc.MatchaConfig(), _port_cfg(HCFG), device="cpu")
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 12, 8)).astype(np.float32))
    before = gen(mel).numpy()
    twn.decompose(gen)
    assert twn.is_weight_norm(gen)
    got, want = flatten_tree(to_jax_tree(gen)), flatten_tree(jwn.decompose(tree))
    assert got.keys() == want.keys()
    _close(got, want, 1e-6, "(v, g)")
    np.testing.assert_allclose(gen(mel).numpy(), before, atol=1e-6)
    twn.fold(gen)
    assert not twn.is_weight_norm(gen)
    back = flatten_tree(to_jax_tree(gen))
    for k, v in flatten_tree(tree).items():
        np.testing.assert_allclose(back[k], v, rtol=1e-6, atol=1e-7, err_msg=k)


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    """Save after one disc+gen pair, restore into a fresh state, and take
    the next pair in both: the same parameters and optimiser states (a
    small state: Vocos with MRD alone, weight norm and grad_clip on)."""
    from matcha_tts_tpu_torch.train.loop import Checkpointer

    def fresh():
        return ttrain.create_gan_state(_port_cfg(VCFG), discriminators=("mrd",),
                                       use_weight_norm=True, grad_clip=5.0, seed=3,
                                       device="cpu")

    audio = torch.from_numpy(_audio(5))
    state = fresh()
    ttrain.gan_disc_step(state, audio, TA)
    ttrain.gan_gen_step(state, audio, TA)
    ckpt = Checkpointer(tmp_path / "ckpt")
    ckpt.save(state.step, state)
    other = ckpt.restore(fresh())
    assert other.step == state.step == 1 and other.gen_opt.updates == 1
    for s in (state, other):
        ttrain.gan_disc_step(s, audio, TA)
        ttrain.gan_gen_step(s, audio, TA)
    for a, b in ((state.generator, other.generator),
                 (state.discriminators, other.discriminators)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb), ka
    sa, sb = state.gen_opt.state_dict(), other.gen_opt.state_dict()
    for i, st in sa["adam"]["state"].items():
        assert torch.equal(st["exp_avg_sq"], sb["adam"]["state"][i]["exp_avg_sq"])


def _tone_corpus(root, seed):
    """An LJSpeech-layout corpus of 22050 Hz tones drawn from `seed`."""
    from matcha_tts_tpu_torch.utils.wav import write_wav

    rng = np.random.default_rng(seed)
    (root / "wavs").mkdir(parents=True)
    lines = []
    for i in range(4):
        n = int(22050 * rng.uniform(0.2, 0.4))
        t = np.arange(n) / 22050
        wav = 0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * t) + 0.01 * rng.standard_normal(n)
        write_wav(root / "wavs" / f"u{i}.wav", wav.astype(np.float32), 22050)
        lines.append(f"u{i}|A tone number {i}.|A tone number {i}.")
    (root / "metadata.csv").write_text("\n".join(lines) + "\n")


def test_vocoder_cli_trains_resumes_and_refuses(tmp_path, capsys):
    from matcha_tts_tpu_torch.train import vocoder_cli

    _tone_corpus(tmp_path / "corpus", 0)
    work = tmp_path / "run"
    # MRD alone keeps it short (MPD holds 41M parameters)
    base = ["--data_root", str(tmp_path / "corpus"), "--family", "vocos", "--debug_tiny",
            "--discriminators", "mrd", "--batch_size", "1", "--segment_size", "2048",
            "--log_every", "1", "--work_dir", str(work), "--device", "cpu"]
    state = vocoder_cli.main(base + ["--steps", "2"])
    assert state.step == 2 and (work / "gan_meta.json").exists()
    assert list(state.discriminators.keys()) == ["mrd"]
    state = vocoder_cli.main(base + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and state.step == 3
    assert (work / "metrics.jsonl").read_text().count('"split": "train"') == 3
    with pytest.raises(SystemExit, match="gan_meta|holds checkpoints"):
        vocoder_cli.main(base + ["--steps", "4", "--weight_norm"])
    # --data_parallel runs under torchrun's environment (a world of one here);
    # on the CPU it needs the backend named
    with pytest.raises(ValueError, match="pass backend='gloo'"):
        vocoder_cli.main(base + ["--data_parallel"])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
                         WORLD_SIZE="1", LOCAL_RANK="0").items():
            mp.setenv(k, v)
        try:
            state = vocoder_cli.main(base + ["--steps", "4", "--data_parallel",
                                             "--backend", "gloo"])
        finally:
            torch.distributed.destroy_process_group()
    assert state.step == 4 and "resumed from step 3" in capsys.readouterr().out


def test_vocos_generator_gradients_reach_every_parameter():
    tree = numpy_tree(lambda key: jvocos.init_vocos(key, VCFG), 4)
    _, voc = load_jax_tree({"vocoder": tree}, tc.MatchaConfig(), _port_cfg(VCFG), device="cpu")
    mel = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 12, 8)).astype(np.float32))
    voc.forward_train(mel).abs().mean().backward()
    for name, p in voc.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name
