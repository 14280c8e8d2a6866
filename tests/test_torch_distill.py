"""The port's few-step distillation (`train/distill.py`) against the JAX
package's, in fp32 on the CPU, at the JAX tests' tiny config
(`tests/test_distill.py`), on a tree drawn with numpy (`port_params.py`).

JAX draws z0, t and the consistency grid index from its key; the tests
replay that key schedule (`fold_in(key, step)`, then `split` into the
trajectory and loss keys) and inject the values into the port.  Tolerances:
conditioning, endpoints and losses atol 1e-5; one `distill_step` of each
loss: the loss, the pre-clip gradient norm, every leaf of the updated
student and of the EMA, atol 1e-5 (save where the first Adam step is
ill-conditioned, see the test), with a student and an EMA that differ from
the teacher; `distill_eval` atol 1e-5.  Also:
`distill_fit`'s batches equal JAX's, a Checkpointer round trip of a
`DistillState`, the CLI for two steps on the CPU, and the trained
distilled student `tests/golden/trained/student_tone.ckpt` at NFE 2
against the JAX package's `synthesize` on the same noise (mel atol 1e-3,
as `tests/test_torch_cli.py`)."""

import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tts_tpu import config as jcfg
from matcha_tts_tpu.models.matcha import init_matcha
from matcha_tts_tpu.train import distill as jdistill
from matcha_tts_tpu_torch import config as tcfg
from matcha_tts_tpu_torch.params.from_jax import load_jax_tree, to_jax_tree
from matcha_tts_tpu_torch.train import distill
from port_params import numpy_tree

T_Y = 64
GOLDEN = Path(__file__).resolve().parent / "golden" / "trained"


def tiny_cfg():
    return jcfg.MatchaConfig(
        encoder=jcfg.EncoderConfig(n_feats=8, n_channels=32, filter_channels=64, n_heads=2,
                                   n_layers=1, p_dropout=0.0),
        duration_predictor=jcfg.DurationPredictorConfig(filter_channels_dp=32),
        decoder=jcfg.DecoderConfig(channels=(16, 16), attention_head_dim=8, num_heads=2,
                                   n_blocks=1, num_mid_blocks=1),
        audio=jcfg.AudioConfig(n_mels=8, hop_length=16))


def port_cfg(jc):
    return tcfg.config_from_dict(tcfg.MatchaConfig, jcfg.config_to_dict(jc))


def port_dcfg(jd):
    return distill.DistillConfig(**dataclasses.asdict(jd))


@functools.lru_cache(maxsize=1)
def teacher_params():
    cfg = tiny_cfg()
    return numpy_tree(lambda key: init_matcha(key, cfg), 0,
                      fixed={"mel_mean": cfg.audio.mel_mean, "mel_std": cfg.audio.mel_std})


def port_teacher():
    model, _ = load_jax_tree({"matcha": teacher_params()}, port_cfg(tiny_cfg()), device="cpu")
    return model


def text_batch(b=4, t_x=24, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 170, size=(b, t_x)).astype(np.int32)
    x_lengths = rng.integers(t_x // 2, t_x + 1, size=(b,)).astype(np.int32)
    for r in range(b):
        x[r, x_lengths[r]:] = 0
    return x, x_lengths


def jax_draws(key, step, shape, jd):
    """z0 (before the temperature), t (B, 1, 1) and idx (B,) as JAX's
    distill_step draws them at `step`."""
    k_traj, k_loss = jax.random.split(jax.random.fold_in(key, step))
    z0 = np.array(jax.random.normal(k_traj, shape, jnp.float32))
    t = np.array(jdistill._sample_t(k_loss, shape[0], jd))
    idx = np.array(jax.random.randint(k_loss, (shape[0],), 0, jd.nfe_teacher))
    return z0, t, idx, k_loss


def _t(a):
    return torch.from_numpy(np.asarray(a))


def off_teacher(scale):
    """The teacher's tree scaled, for a student or an EMA that is not the
    teacher (so that a swap of the three networks shows)."""
    return jax.tree_util.tree_map(lambda a: a * scale, teacher_params())


def test_conditioning_endpoints_and_eval_match_jax():
    """`expand_conditioning`, `_teacher_endpoints` with z0 from JAX's
    trajectory key, and `distill_eval` of a student off the teacher from
    the same key (so one teacher solve serves both on the JAX side)."""
    jc, params = tiny_cfg(), teacher_params()
    jd = jdistill.DistillConfig(nfe_teacher=2, temperature=0.8)
    x, xl = text_batch()
    k_traj = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 0))[0]
    student = off_teacher(1.02)

    @jax.jit
    def jax_side(x, xl):
        mu_y, y_mask, _ = jdistill.expand_conditioning(params, x, xl, jc, T_Y)
        z0, x1 = jdistill._teacher_endpoints(params, k_traj, mu_y, y_mask, jc, jd)
        err = jdistill.distill_eval(student, params, k_traj, x, xl, jc, jd, T_Y, nfe_student=2)
        return mu_y, y_mask, z0, x1, err

    mu_y, y_mask, jz0, jx1, jerr = jax_side(jnp.asarray(x), jnp.asarray(xl))
    z0_raw = np.array(jax.random.normal(k_traj, mu_y.shape, jnp.float32))
    teacher = port_teacher()
    pcfg, pd = port_cfg(jc), port_dcfg(jd)
    pmu, pmask, _ = distill.expand_conditioning(teacher, _t(x).long(), _t(xl).long(), T_Y)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(y_mask))
    assert 0 < float(pmask.sum()) < pmask.numel()  # ragged frames
    np.testing.assert_allclose(pmu.numpy(), np.asarray(mu_y), atol=1e-5)
    z0, x1 = distill._teacher_endpoints(teacher, pmu, pmask, pcfg, pd, z0=_t(z0_raw))
    np.testing.assert_allclose(z0.numpy(), np.asarray(jz0), atol=1e-6)
    np.testing.assert_allclose(x1.numpy(), np.asarray(jx1), atol=1e-5)
    pstudent, _ = load_jax_tree({"matcha": student}, pcfg, device="cpu")
    err = distill.distill_eval(pstudent, teacher, _t(x).long(), _t(xl).long(), pcfg, pd, T_Y,
                               nfe_student=2, z0=_t(z0_raw))
    np.testing.assert_allclose(float(err), float(jerr), atol=1e-5)
    assert float(err) > 0


def _leaves_close(got_tree, want_tree, atol, what):
    paths = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = jax.tree_util.tree_leaves(got_tree)
    assert len(paths) == len(got)
    for (path, w), g in zip(paths, got):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("loss", ["reflow", "consistency"])
def test_distill_step_matches_jax(loss):
    """Loss, gradient norm, every EMA weight and every student weight at atol
    1e-5, with one exception that the optimizer forces.  Adam's first step
    moves a weight by lr * g / (|g| + 1e-8), whose slope at g = 0 is lr *
    1e8: a gradient entry within a few eps of zero (of the 42,648 nonzero
    entries here, 3-4 fall below 1e-8 by accident) turns fp32
    summation-order noise of 1e-9 into a weight difference of 1e-5 to 1e-4.
    Where the port's gradient is nonzero and below 1e-7 (9-15 entries) the
    student's weight is held to 2 lr (the most one Adam step can differ);
    the EMA moves by 1 - 0.995 of that, inside 1e-5 everywhere."""
    jc, params = tiny_cfg(), teacher_params()
    jd = jdistill.DistillConfig(loss=loss, nfe_teacher=2, learning_rate=1e-3)
    x, xl = text_batch()
    key = jax.random.PRNGKey(1)
    # student, EMA and teacher all differ, so that a swap of the three shows
    student, ema = off_teacher(1.01), off_teacher(0.99)
    jstate = jdistill.create_distill_state(student, jd)._replace(ema_params=ema)
    jstate2, jm = jdistill.distill_step(jstate, params, key, jnp.asarray(x), jnp.asarray(xl),
                                        jc, jd, T_Y)
    z0, t, idx, _ = jax_draws(key, 0, (x.shape[0], T_Y, jc.encoder.n_feats), jd)

    teacher = port_teacher()
    pstudent, pema = (load_jax_tree({"matcha": tree}, port_cfg(jc), device="cpu")[0]
                      for tree in (student, ema))
    state = distill.create_distill_state(pstudent, port_dcfg(jd))
    state.ema = pema.requires_grad_(False)
    e0 = state.ema.decoder.estimator.final_proj.weight.detach().clone()
    s0 = state.student.decoder.estimator.final_proj.weight.detach().clone()
    m = distill.distill_step(state, teacher, _t(x).long(), _t(xl).long(), port_cfg(jc),
                             port_dcfg(jd), T_Y, z0=_t(z0), t=_t(t), idx=_t(idx))
    assert state.step == 1
    np.testing.assert_allclose(float(m["distill_loss"]), float(jm["distill_loss"]), atol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), atol=1e-5)
    _leaves_close(to_jax_tree(state.ema), jstate2.ema_params, 1e-5, "ema")
    got = jax.tree_util.tree_leaves(to_jax_tree(state.student))
    grads = jax.tree_util.tree_leaves(to_jax_tree(state.student, grads=True))  # kept after step
    paths = jax.tree_util.tree_flatten_with_path(jstate2.params)[0]
    n_ill, n_all = 0, sum(g.size for g in grads)
    for (path, want), g, grad in zip(paths, got, grads):
        ill = (grad != 0) & (np.abs(grad) < 1e-7)
        n_ill += int(ill.sum())
        err = np.abs(g - np.asarray(want))
        assert err[~ill].max(initial=0.0) <= 1e-5, jax.tree_util.keystr(path)
        assert err[ill].max(initial=0.0) <= 2 * jd.learning_rate, jax.tree_util.keystr(path)
    assert n_ill <= 0.002 * n_all  # 9 (reflow) and 15 (consistency) of 88,931 here
    # the student moved, the EMA less, the teacher not at all
    with torch.no_grad():
        ws = state.student.decoder.estimator.final_proj.weight
        we = state.ema.decoder.estimator.final_proj.weight
        assert 0 < float((we - e0).abs().max()) < float((ws - s0).abs().max())
    assert all(p.grad is None for p in teacher.parameters())


def test_distill_fit_batches_match_jax(monkeypatch):
    """Both fit loops, their steps replaced by a recorder: the same text rows."""
    texts = ["Hello there.", "A second line of text.", "And a third, longer one here."]
    seen = {"jax": [], "port": []}

    def jstep(state, teacher, key, x, xl, *a):
        seen["jax"].append((np.asarray(x), np.asarray(xl)))
        return state, {"distill_loss": jnp.float32(0.0)}

    def pstep(state, teacher, x, xl, *a, **kw):
        seen["port"].append((x.numpy(), xl.numpy()))
        return {"distill_loss": torch.tensor(0.0)}

    monkeypatch.setattr(jdistill, "distill_step", jstep)
    monkeypatch.setattr(distill, "distill_step", pstep)
    jdistill.distill_fit(teacher_params(), tiny_cfg(), jdistill.DistillConfig(), texts, steps=3,
                         batch_size=5, text_bucket=32, seed=4, callback=lambda s, m: None)
    distill.distill_fit(port_teacher(), port_cfg(tiny_cfg()), distill.DistillConfig(), texts,
                        steps=3, batch_size=5, text_bucket=32, seed=4,
                        callback=lambda s, m: None)
    assert len(seen["jax"]) == len(seen["port"]) == 3
    for (jx, jl), (px, pl) in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(pl, jl)


def test_checkpointer_round_trips_a_distill_state(tmp_path):
    from matcha_tts_tpu_torch.train.loop import Checkpointer

    pcfg = port_cfg(tiny_cfg())
    dcfg = distill.DistillConfig(loss="consistency", nfe_teacher=2, learning_rate=1e-3)
    teacher = port_teacher()
    state = distill.distill_fit(teacher, pcfg, dcfg, ["Hello there.", "Two lines."], steps=2,
                                batch_size=2, text_bucket=32, frame_bucket=T_Y,
                                callback=lambda s, m: None)
    ck = Checkpointer(tmp_path / "ckpt")
    ck.save(state.step, state, pcfg)
    fresh = distill.create_distill_state(teacher, dcfg)
    assert ck.restore(fresh).step == 2
    for a, b in ((fresh.student, state.student), (fresh.ema, state.ema)):
        for (name, v), w in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(v, w), name
    opt, want = fresh.optimizer.state_dict(), state.optimizer.state_dict()
    assert opt["state"].keys() == want["state"].keys() and len(opt["state"]) > 0
    assert all(int(v["step"]) == 2 for v in opt["state"].values())
    student = ck.load_model(device="cpu")
    x, xl = text_batch(b=2, t_x=16, seed=3)
    out = student.synthesize(_t(x).long(), _t(xl).long(), n_timesteps=2, t_y_max=T_Y)
    ref = state.student.synthesize(_t(x).long(), _t(xl).long(), n_timesteps=2, t_y_max=T_Y)
    assert torch.equal(out.mel, ref.mel) and torch.isfinite(out.mel).all()


def test_cli_distills_and_saves_on_the_cpu(tmp_path, capsys, monkeypatch):
    import sys

    from matcha_tts_tpu_torch.train.loop import Checkpointer

    # MetricsLogger without TensorBoard writes its JSONL only (and the test
    # skips TensorBoard's import, most of its time)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    texts = tmp_path / "texts.txt"
    texts.write_text("wavs/a.wav|A line from a filelist.\nA plain line.\n")
    work = tmp_path / "run"
    state = distill.main(["--teacher", str(GOLDEN / "matcha_tone.ckpt"), "--texts", str(texts),
                          "--steps", "2", "--batch_size", "2", "--nfe-teacher", "2",
                          "--frame_bucket", "128", "--text_bucket", "64", "--device", "cpu",
                          "--work_dir", str(work)])
    assert state.step == 2 and "saved distilled student" in capsys.readouterr().out
    assert not (work / "tb").exists() and (work / "metrics.jsonl").exists()
    assert Checkpointer(work / "ckpt").load_model(device="cpu").cfg == state.student.cfg


def test_trained_student_synthesizes_like_jax():
    """The distilled student in the repository at NFE 2, through the port's
    CLI loader and the JAX package's converter (its CLI loader minus the
    random vocoder it draws), on the same injected noise."""
    from matcha_tts_tpu.models.matcha import synthesize as jsynthesize
    from matcha_tts_tpu.params import convert as jconvert
    from matcha_tts_tpu_torch.inference.cli import load_models

    sd, hyper = jconvert.load_torch_checkpoint(str(GOLDEN / "student_tone.ckpt"))
    jc = jcfg.config_from_dict(jcfg.MatchaConfig, hyper)
    params = jconvert.convert_matcha(sd, jc)
    model, pc, _, _ = load_models(str(GOLDEN / "student_tone.ckpt"), None, device="cpu")
    assert tcfg.config_to_dict(pc) == jcfg.config_to_dict(jc)
    rng = np.random.default_rng(1)
    lengths = np.array([31, 19])
    x = np.zeros((2, 48), np.int64)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.integers(1, 178, n)
    key = jax.random.PRNGKey(9)
    ref = jsynthesize(params, key, jnp.asarray(x), jnp.asarray(lengths), jc, n_timesteps=2,
                      t_y_max=256, temperature=0.667)
    z = np.array(jax.random.normal(key, (2, 256, jc.encoder.n_feats), jnp.float32))
    got = model.synthesize(_t(x), _t(lengths), n_timesteps=2, t_y_max=256, temperature=0.667,
                           z=_t(z))
    np.testing.assert_array_equal(got.y_lengths.numpy(), np.asarray(ref.y_lengths))
    assert int(got.y_lengths.min()) > 30
    np.testing.assert_allclose(got.mel.numpy(), np.asarray(ref.mel), atol=1e-3)
