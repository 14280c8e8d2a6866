"""The comparison that decides `correct` has to reject what is wrong.

* The control: the reference computed in fp8 (e4m3 operands with
  per-tensor scales, and the timestep embedding's values), put in the
  program's place, fails at least one of the cell's limits.
* Faults planted under the timed path, each driving the rest of a run:
  an answer (durations, mel, PCM) altered where it is produced, the
  duration predictor's dropout left on, half of a batch left out, and for
  training a step that leaves the state unchanged (from the first step, or
  only after the warm-up) and a loss taken over half of the batch.  Each
  run reads `correct` false.

At the tiny size of `tests/tiny.py`, on the CPU.

The cells are picked by the driver that runs them (their traffic's
`driver`), not by name: the planted faults are the Matcha synthesis path's
(`offline`, `serve`) and the training step's (`train`).  A cell of another
driver, such as a model of another family, is rehearsed by
`test_portbench_cells.py` and by the controls and faults that its own PR
adds in a test file of its own."""

import time

import numpy as np
import pytest
import torch

from portbench.lib import harness, spec, synth_check, train_check
from portbench.lib.context import Context
from portbench.tests.test_portbench_cells import CELLS, DRIVERS

SYNTH_CELLS = [c for c in CELLS if DRIVERS[c] in ("offline", "serve")]
TRAIN_CELLS = [c for c in CELLS if DRIVERS[c] == "train"]


def _ctx(tiny, name, seed=11):
    return Context(spec.find_cell(name, *tiny), seed, 1.0, False, time.perf_counter(),
                   device="cpu")


def _fails(numbers, limits):
    return any(not numbers[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("name", [c for c in SYNTH_CELLS if DRIVERS[c] == "offline"])
def test_synthesis_control_fails(tiny, name):
    ctx = _ctx(tiny, name)
    drv = spec.driver(ctx.cell.traffic)
    run = drv.run(ctx)
    ref = synth_check.SynthReference(run["config"], run["params"], "fp32", "cpu")
    ctl = synth_check.SynthReference(run["config"], run["params"], "fp8", "cpu")
    rows = []
    for s in drv.sample(ctx, run):
        prog, t_y = synth_check.judge_sample(ref, s)
        assert not _fails(prog, ctx.cell.workload["limits"])
        rows.append(synth_check.judge(ref, ctl.produce(s.text, s.seed, t_y), t_y))
    assert _fails(synth_check.worst(rows), ctx.cell.workload["limits"])


def _alter_pcm(monkeypatch):
    from matcha_tts_tpu_torch.inference import synthesizer
    orig = synthesizer.pack_pcm

    def broken(wav, y_lengths, denoiser, strength):  # off by one sample
        return orig(torch.roll(wav, 1, dims=-1), y_lengths, denoiser, strength)
    monkeypatch.setattr(synthesizer, "pack_pcm", broken)


def _alter_mel(monkeypatch):
    from matcha_tts_tpu_torch.models.matcha import MatchaTTS
    orig = MatchaTTS.synthesize

    def broken(self, *a, **kw):
        out = orig(self, *a, **kw)  # off by one frame
        return out._replace(mel=torch.roll(out.mel, 1, dims=-1))
    monkeypatch.setattr(MatchaTTS, "synthesize", broken)


def _alter_durations(monkeypatch):
    from matcha_tts_tpu_torch.models.matcha import MatchaTTS
    orig = MatchaTTS._durations

    def broken(self, logw, x_mask, length_scale):  # every token one frame long
        return orig(self, logw, x_mask, length_scale) + x_mask.float()
    monkeypatch.setattr(MatchaTTS, "_durations", broken)


def _drop_half_batch(monkeypatch):
    """The second half of each batch's rows synthesised from the first
    row's tokens."""
    from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
    orig = Synthesizer._inputs

    def broken(self, rows, t_x, batch, spk=None):
        x, x_lengths, spks = orig(self, rows, t_x, batch, spk)
        h = len(rows) // 2
        if h:
            x[h:len(rows)] = x[0]
            x_lengths[h:len(rows)] = x_lengths[0]
        return x, x_lengths, spks
    monkeypatch.setattr(Synthesizer, "_inputs", broken)


def _predictor_dropout(monkeypatch):
    """The duration predictor with its dropout on (left in training mode)."""
    from matcha_tts_tpu_torch.models.layers import DurationPredictor
    orig = DurationPredictor.forward

    def broken(self, x, x_mask, p_dropout=0.0, generator=None):
        g = torch.Generator(device=x.device).manual_seed(7)
        return orig(self, x, x_mask, 0.1, g)
    monkeypatch.setattr(DurationPredictor, "forward", broken)


SYNTH_FAULTS = {"pcm": _alter_pcm, "mel": _alter_mel, "durations": _alter_durations,
                "half_batch": _drop_half_batch, "predictor_dropout": _predictor_dropout}


@pytest.mark.parametrize("fault", sorted(SYNTH_FAULTS))
@pytest.mark.parametrize("name", SYNTH_CELLS)
def test_synthesis_fault_is_not_correct(tiny, monkeypatch, name, fault):
    SYNTH_FAULTS[fault](monkeypatch)
    rc, result, _ = harness.execute(_ctx(tiny, name))
    assert rc == 0
    assert result["correct"] is False, result["check"]


def _state_unchanged(monkeypatch):
    from matcha_tts_tpu_torch.train import train_state
    orig = train_state.train_step

    def broken(state, batch, model_cfg, train_cfg, mesh=None):
        saved = [p.detach().clone() for p in state.model.parameters()]
        out = orig(state, batch, model_cfg, train_cfg, mesh)
        with torch.no_grad():
            for p, s in zip(state.model.parameters(), saved):
                p.copy_(s)
        return out
    monkeypatch.setattr(train_state, "train_step", broken)


def _half_batch_loss(monkeypatch):
    from matcha_tts_tpu_torch.train import train_state
    orig = train_state._batch_losses

    def broken(model, batch, *a):
        h = max(1, batch["x"].shape[0] // 2)
        return orig(model, {k: v[:h] for k, v in batch.items()}, *a)
    monkeypatch.setattr(train_state, "_batch_losses", broken)


def _state_unchanged_after_warmup(monkeypatch):
    """A step that returns the state unchanged from the fifth step on: a path
    that the first three steps do not take."""
    from matcha_tts_tpu_torch.train import train_state
    orig = train_state.train_step

    def broken(state, batch, model_cfg, train_cfg, mesh=None):
        if state.step < 4:
            return orig(state, batch, model_cfg, train_cfg, mesh)
        saved = [p.detach().clone() for p in state.model.parameters()]
        out = orig(state, batch, model_cfg, train_cfg, mesh)
        with torch.no_grad():
            for p, s in zip(state.model.parameters(), saved):
                p.copy_(s)
        return out
    monkeypatch.setattr(train_state, "train_step", broken)


TRAIN_FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch_loss,
                "state_unchanged_after_warmup": _state_unchanged_after_warmup}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_fault_is_not_correct(tiny, monkeypatch, name, fault):
    TRAIN_FAULTS[fault](monkeypatch)
    rc, result, _ = harness.execute(_ctx(tiny, name))
    assert rc == 0
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_control_fails(tiny, name):
    ctx = _ctx(tiny, name)
    drv = spec.driver(ctx.cell.traffic)
    run = drv.run(ctx)
    theta_init = run["params"]["matcha"]
    limits = dict(ctx.cell.workload["limits"])
    limits.pop("loader_miss")
    assert run["kept"][0]["step"] == 0 and run["kept"][1]["step"] > 3
    for kept in run["kept"]:
        ref, theta = train_check.triple_reference(run["config"], theta_init, kept, "cpu")
        prog = train_check.numbers_of(kept, ref, theta)
        assert not _fails(prog, limits)
        ctl, _ = train_check.triple_reference(run["config"], theta_init, kept, "cpu", "fp8")
        assert _fails(train_check.numbers_of(ctl, ref, theta), limits)
        assert np.isfinite(list(prog.values())).all()
