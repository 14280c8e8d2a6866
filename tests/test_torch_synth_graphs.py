"""`Synthesizer`'s solver-step CUDA graphs (`inference/graphs.py`) against
the eager call.

On a card (marker `gpu`; they skip where there is none) a graphed call
equals the eager `model.synthesize`, vocoder and `pack_pcm` bit for bit: in
bf16 and fp32, Euler and midpoint, with and without a speaker, at batch 1
and 8 and two frame buckets, each key captured once and replayed
`n_timesteps` times a call; a second call at one key leaves the first's
results as they were; two threads calling at once get the sequential
results; parameters replaced after a capture are followed; every
`n_timesteps` shares one key's graph; a change of the TF32 modes captures
the key anew.  Run on a machine with one:

    python -m pytest --noconftest tests/test_torch_synth_graphs.py -q

On the CPU no graph is captured: the call is the eager one, and the
graphs' split of `model.synthesize` (`prepare`, the initial state, the
steps with `t`, `t_mid` and a 0-dim `dt` filled in place, `finish`) equals
it.
"""

import threading

import numpy as np
import pytest
import torch

from matcha_tts_tpu_torch import config as C
from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
from matcha_tts_tpu_torch.models import cfm
from matcha_tts_tpu_torch.models.hifigan import HiFiGANGenerator
from matcha_tts_tpu_torch.models.matcha import MatchaTTS, as_dtype

NFE = 3
TEXTS = ["Hello world, this is a test.", "A second, longer sentence of the batch here.",
         "Short one.", "The birch canoe slid on the smooth planks."]
OTHER = ["Another text entirely.", "It is easy to tell the depth of a well.",
         "Four score and seven.", "Glue the sheet to the dark blue background."]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _synth(device, dtype="bfloat16", solver="euler", n_spks=1):
    """A small model and an audible small HiFi-GAN (every conv redrawn at
    unit gain) with the denoiser."""
    cfg = C.MatchaConfig(
        n_spks=n_spks,
        encoder=C.EncoderConfig(n_channels=64, filter_channels=128, n_heads=2, n_layers=2),
        duration_predictor=C.DurationPredictorConfig(filter_channels_dp=64),
        decoder=C.DecoderConfig(channels=(64, 64), attention_head_dim=32, num_heads=2,
                                num_mid_blocks=1),
        cfm=C.CFMConfig(solver=solver))
    hcfg = C.HiFiGANConfig(upsample_initial_channel=32)
    model = MatchaTTS(cfg, seed=3, device=device)
    voc = HiFiGANGenerator(hcfg, seed=1, device=device)
    g = torch.Generator(device="cpu").manual_seed(5)
    with torch.no_grad():
        for name, p in voc.named_parameters():
            if name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=g) * (p[0].numel()) ** -0.5)
        voc.conv_post.weight.mul_(0.1)
    return Synthesizer(model, cfg, voc, hcfg, text_buckets=(64,), frame_buckets=(128, 256),
                       batch_frame_buckets=(128, 256), compute_dtype=dtype,
                       denoise_strength=0.00025, device=device)


def _inputs(syn, batch, spk):
    rows = [syn.tokenize(TEXTS[i % len(TEXTS)])[:64] for i in range(batch)]
    x, xl, spks = syn._inputs(rows, 64, batch, spk)
    return x, xl, spks, [syn._noise_id(r) for r in rows]


def _eager(syn, x, xl, t_y, spks, seed, noise_ids, nfe=NFE):
    """The eager call: `model.synthesize`, the vocoder, the denoiser, `pack_pcm`."""
    out = syn.model.synthesize(x, xl, n_timesteps=nfe, t_y_max=t_y, temperature=0.667,
                               length_scale=1.0, spks=spks,
                               compute_dtype=as_dtype(syn.compute_dtype), seed=seed,
                               noise_ids=noise_ids)
    return syn._vocode_packed(out.mel, out.y_lengths), out


def _assert_same(got, want):
    (packed, out), (want_packed, want_out) = got, want
    for name, a, b in (("packed", packed, want_packed), ("mel", out.mel, want_out.mel),
                       ("attn", out.attn, want_out.attn),
                       ("y_lengths", out.y_lengths, want_out.y_lengths),
                       ("durations", out.durations, want_out.durations)):
        assert a.dtype == b.dtype and torch.equal(a, b), (
            name, float((a.float() - b.float()).abs().max()))


def _host(results):
    return [(r.pcm16.copy(), r.mel, r.attn) for r in results]


@pytest.mark.gpu
@pytest.mark.parametrize("spk", [None, 2])
@pytest.mark.parametrize("solver", ["euler", "midpoint"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_graphed_call_equals_the_eager_call(cuda, dtype, solver, spk):
    """Batch 1 and 8 at frame buckets 128 and 256: the first call at a key
    captures it, every call replays `NFE` steps and equals the eager call
    bit for bit (the packed PCM16, mel, alignment, lengths, durations)."""
    syn = _synth(cuda, dtype, solver, n_spks=1 if spk is None else 3)
    for batch in (1, 8):
        x, xl, spks, ids = _inputs(syn, batch, spk)
        for t_y in (128, 256):
            want = _eager(syn, x, xl, t_y, spks, 7, ids)
            for call in range(2):
                before = dict(syn.stats)
                got = syn._synthesize_packed(x, xl, t_y, NFE, 0.667, 1.0, spks, 7, ids)
                assert syn.stats["graph_captures"] - before["graph_captures"] == (call == 0)
                assert syn.stats["graph_replays"] - before["graph_replays"] == NFE
                assert syn.stats["eager_steps"] == 0
                _assert_same(got, want)
            assert float(want[1].mel.abs().max()) > 0
            assert int(want[0][:-batch].abs().max()) > 0  # audible samples
    assert syn.stats["graph_captures"] == 4


@pytest.mark.gpu
def test_second_call_at_one_key_leaves_the_first_results(cuda):
    """Two `synthesize_batch` calls at one key, the first's results read
    only after the second: its PCM16, mel and alignment are those it gives
    when read at once."""
    syn = _synth(cuda)
    want = _host(syn.synthesize_batch(TEXTS, n_timesteps=NFE, seed=1))
    first = syn.synthesize_batch(TEXTS, n_timesteps=NFE, seed=1)
    captures = syn.stats["graph_captures"]
    second = syn.synthesize_batch(OTHER, n_timesteps=NFE, seed=1)
    assert syn.stats["graph_captures"] == captures  # the same key: no capture
    for (pcm, mel, attn), r in zip(want, first):
        np.testing.assert_array_equal(r.pcm16, pcm)
        np.testing.assert_array_equal(r.mel, mel)
        np.testing.assert_array_equal(r.attn, attn)
    assert not all(np.array_equal(a.pcm16, b[0]) for a, b in zip(second, want))


@pytest.mark.gpu
def test_two_threads_at_once_give_the_sequential_results(cuda):
    """Two threads call `synthesize_batch` on one engine at once, three
    times each: every result equals the sequential call's."""
    syn = _synth(cuda)
    texts = {0: TEXTS, 1: OTHER}
    want = {k: _host(syn.synthesize_batch(v, n_timesteps=NFE, seed=2)) for k, v in texts.items()}
    got = {0: [], 1: []}
    errors = []
    start = threading.Barrier(2)

    def worker(k):
        try:
            start.wait()
            for _ in range(3):
                got[k].append(_host(syn.synthesize_batch(texts[k], n_timesteps=NFE, seed=2)))
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in texts]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for k in texts:
        assert len(got[k]) == 3
        for rows in got[k]:
            for (pcm, mel, attn), (wpcm, wmel, wattn) in zip(rows, want[k]):
                np.testing.assert_array_equal(pcm, wpcm)
                np.testing.assert_array_equal(mel, wmel)
                np.testing.assert_array_equal(attn, wattn)


@pytest.mark.gpu
def test_replaced_parameters_are_followed(cuda):
    """After a capture, the estimator's parameters are replaced (new
    storage, `.data =`; the graphs are captured anew), overwritten in place
    (`load_state_dict`; the same graphs read them), and one is replaced by
    a new `Parameter` (captured anew): each call equals the eager call on
    the weights it has then."""
    syn = _synth(cuda)
    x, xl, spks, ids = _inputs(syn, 2, None)
    _assert_same(syn._synthesize_packed(x, xl, 128, NFE, 0.667, 1.0, spks, 3, ids),
                 _eager(syn, x, xl, 128, spks, 3, ids))
    est = syn.model.decoder.estimator
    with torch.no_grad():
        for p in est.parameters():
            p.data = p.data * 1.25
    want = _eager(syn, x, xl, 128, spks, 3, ids)
    _assert_same(syn._synthesize_packed(x, xl, 128, NFE, 0.667, 1.0, spks, 3, ids), want)
    assert syn.stats["graph_captures"] == 2
    state = {k: v * 0.8 for k, v in est.state_dict().items()}
    est.load_state_dict(state)
    want2 = _eager(syn, x, xl, 128, spks, 3, ids)
    assert not torch.equal(want2[1].mel, want[1].mel)
    _assert_same(syn._synthesize_packed(x, xl, 128, NFE, 0.667, 1.0, spks, 3, ids), want2)
    assert syn.stats["graph_captures"] == 2
    est.final_proj.weight = torch.nn.Parameter(est.final_proj.weight.detach() * 1.5)
    want3 = _eager(syn, x, xl, 128, spks, 3, ids)
    _assert_same(syn._synthesize_packed(x, xl, 128, NFE, 0.667, 1.0, spks, 3, ids), want3)
    assert syn.stats["graph_captures"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["euler", "midpoint"])
def test_every_n_timesteps_shares_one_key(cuda, solver):
    """Calls at one shape with 1 to 12 solver steps capture one graph (the
    step size is a buffer, not part of the key) and each equals the eager
    call at its own `n_timesteps`."""
    syn = _synth(cuda, solver=solver)
    x, xl, spks, ids = _inputs(syn, 2, None)
    for nfe in (1, 2, 3, 5, 8, 12):
        want = _eager(syn, x, xl, 128, spks, 6, ids, nfe)
        before = syn.stats["graph_replays"]
        got = syn._synthesize_packed(x, xl, 128, nfe, 0.667, 1.0, spks, 6, ids)
        assert syn.stats["graph_replays"] - before == nfe
        _assert_same(got, want)
    assert syn.stats["graph_captures"] == 1 and len(syn._graphs._steps) == 1


@pytest.mark.gpu
def test_tf32_modes_are_part_of_the_key(cuda):
    """fp32: a call with TF32 off, then on, then off again equals the eager
    call under the modes of its time; turning TF32 on captures the key anew,
    turning it off again replays the first graph."""
    syn = _synth(cuda, "float32")
    x, xl, spks, ids = _inputs(syn, 2, None)
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    try:
        for tf32, captures in ((False, 1), (True, 2), (False, 2)):
            matmul.allow_tf32 = cudnn.allow_tf32 = tf32
            want = _eager(syn, x, xl, 128, spks, 8, ids)
            _assert_same(syn._synthesize_packed(x, xl, 128, NFE, 0.667, 1.0, spks, 8, ids),
                         want)
            assert syn.stats["graph_captures"] == captures
    finally:
        matmul.allow_tf32 = cudnn.allow_tf32 = False


def test_cpu_call_is_eager_and_unchanged():
    """On the CPU nothing is captured: `eager_steps` counts `n_timesteps` a
    call, and each row equals the eager call on the same inputs."""
    torch.set_num_threads(1)
    syn = _synth("cpu", "float32")
    results = syn.synthesize_batch(TEXTS[:3], n_timesteps=NFE, seed=4)
    assert syn.stats["graph_captures"] == syn.stats["graph_replays"] == 0
    assert syn.stats["eager_steps"] == NFE * syn.stats["calls"] == NFE
    # the batch as `synthesize_batch` makes it: shortest first, one pad row
    order = sorted(range(3), key=lambda i: len(syn.tokenize(TEXTS[i])))
    rows = [syn.tokenize(TEXTS[i])[:64] for i in order]
    x, xl, spks = syn._inputs(rows, 64, 4)
    ids = [syn._noise_id(r) for r in rows] + [0]
    t_y = syn.predict_frame_bucket(x, xl, 1.0, spks, buckets=syn.batch_frame_buckets)
    packed, out = _eager(syn, x, xl, t_y, spks, 4, ids)
    t_wav = t_y * 256
    for row, i in enumerate(order):
        n = int(out.y_lengths[row])
        r = results[i]
        assert r.y_length == n
        np.testing.assert_array_equal(r.pcm16, packed[row * t_wav:row * t_wav + n * 256].numpy())
        np.testing.assert_array_equal(r.mel, out.mel[row, :, :n].numpy())
    assert syn.stats["eager_steps"] == NFE


@pytest.mark.parametrize("solver,n_spks", [("euler", 1), ("midpoint", 3)])
def test_prepare_steps_finish_equal_synthesize(solver, n_spks):
    """The graphs' split of `model.synthesize`: `prepare`, the initial
    state, `n_timesteps` of `cfm.step` with `t` and `t_mid` filled in place
    and `dt` a 0-dim fp32 tensor, as `inference/graphs.py` gives them,
    `finish`; equal to it bit for bit on the CPU."""
    torch.set_num_threads(1)
    syn = _synth("cpu", "float32", solver, n_spks)
    spk = 1 if n_spks > 1 else None
    x, xl, spks, ids = _inputs(syn, 2, spk)
    model = syn.model
    want = model.synthesize(x, xl, n_timesteps=NFE, t_y_max=128, temperature=0.667,
                            spks=spks, seed=9, noise_ids=ids)
    prep = model.prepare(x, xl, t_y_max=128, spks=spks)
    z = cfm.initial_state(prep.mu_y, 0.667, 9, ids)
    t, t_mid = torch.empty(2), torch.empty(2)
    dt = torch.full((), 1.0 / NFE)

    def est(zz, mask, mu, tt):
        return model.decoder.estimator(zz, mask, mu, tt, prep.spk_emb)

    for i in range(NFE):
        t.fill_(i / NFE)
        torch.add(t, 1.0 / NFE * 0.5, out=t_mid)
        z.copy_(cfm.step(est, z, prep.mask, prep.mu_y, t, dt, solver, t_mid))
    got = model.finish(z, prep)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError):
        cfm.step(est, z, prep.mask, prep.mu_y, t, 0.5, "rk4")
