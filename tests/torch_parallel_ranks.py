"""The rank functions of the data-parallel CPU tests (`test_torch_parallel.py`,
`test_torch_parallel_serving.py`), in a module that imports no JAX, so that
`parallel.launch.spawn` can pickle them and the spawned ranks start without
it.

Each `*_case(mesh)` runs one piece of the port under `mesh` (None: world 1,
in the test process) and returns numpy results; the `*_rank` functions run
every case of one world size in one spawned group.  Weights come from seeds
or, for the serving cases, as numpy trees from the test process.
"""

import dataclasses
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from matcha_tts_tpu_torch import config as C
from matcha_tts_tpu_torch.models.matcha import MatchaTTS
from matcha_tts_tpu_torch.parallel import mesh as pmesh

TEXT_BUCKET, FRAME_BUCKET = 24, 64


def quiet_rank():
    """One intra-op thread (the test workers share the cores), and no
    TensorBoard import (TensorFlow's takes about 20 s) in the logger."""
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None


def tiny_cfg(n_spks: int = 1) -> C.MatchaConfig:
    """The training CLI's `--debug_tiny` model, dropout on."""
    return C.MatchaConfig(
        encoder=C.EncoderConfig(n_channels=32, filter_channels=64, n_heads=2, n_layers=1),
        duration_predictor=C.DurationPredictorConfig(filter_channels_dp=32),
        decoder=C.DecoderConfig(channels=(16, 16), attention_head_dim=8, num_heads=2,
                                n_blocks=1, num_mid_blocks=1),
        n_spks=n_spks, spk_emb_dim=8 if n_spks > 1 else 64)


def global_batch(b: int = 4, seed: int = 0) -> dict:
    """A training batch whose rows' lengths differ, so that every rank's
    mask sums differ from the others'."""
    rng = np.random.default_rng(seed)
    x_lengths = np.array([7, 13, 22, 5, 18, 9, 11, 24][:b], np.int64)
    y_lengths = np.array([30, 64, 51, 17, 60, 25, 40, 64][:b], np.int64)
    x = rng.integers(1, 100, (b, TEXT_BUCKET)) * (np.arange(TEXT_BUCKET) < x_lengths[:, None])
    y = rng.standard_normal((b, FRAME_BUCKET, 80)).astype(np.float32)
    y *= (np.arange(FRAME_BUCKET) < y_lengths[:, None])[..., None]
    return {"x": x, "x_lengths": x_lengths, "y": y, "y_lengths": y_lengths}


def _local(batch: dict, mesh) -> dict:
    if mesh is None:
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    return pmesh.shard_batch(mesh, batch)


def _flat(module) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()]).numpy().copy()


def train_case(mesh) -> dict:
    """One `train_step` with Adam (the losses, the pre-clip norm, the
    parameters after), one with SGD at lr 1 (its update is the clipped
    reduced gradient) and one `eval_step`."""
    from matcha_tts_tpu_torch.train.train_state import (TrainState, create_train_state,
                                                        eval_step, train_step)

    cfg = tiny_cfg()
    tcfg = C.TrainConfig(batch_size=4, mixed_precision=False, seed=3)
    batch = _local(global_batch(), mesh)
    state = create_train_state(MatchaTTS(cfg, seed=0, device="cpu"), tcfg)
    metrics = {k: float(v) for k, v in train_step(state, batch, cfg, tcfg, mesh).items()}
    model = MatchaTTS(cfg, seed=0, device="cpu")
    before = _flat(model)
    sgd = TrainState(0, model, torch.optim.SGD(model.parameters(), lr=1.0))
    train_step(sgd, batch, cfg, dataclasses.replace(tcfg, learning_rate=1.0), mesh)
    ev = eval_step(model, batch, cfg, seed=5, mesh=mesh)
    return {"metrics": metrics, "params": _flat(state.model), "grad": before - _flat(model),
            "eval": {k: float(v) for k, v in ev.items()}}


def per_rank_mean_case(mesh) -> dict:
    """Plain DDP's step: each rank's loss over its own denominators, the
    losses and gradients averaged over the ranks."""
    from matcha_tts_tpu_torch.models.cfm import row_seed
    from matcha_tts_tpu_torch.train.train_state import _batch_losses

    cfg = tiny_cfg()
    batch = _local(global_batch(), mesh)
    model = MatchaTTS(cfg, seed=0, device="cpu")
    sh = pmesh.batch_sharding(mesh)
    g = torch.Generator().manual_seed(row_seed(3, 0))
    rows = pmesh.BatchRows.for_rank(g, sh, batch["x"].shape[0])
    rows.sharding = None  # the rank's own denominators
    out = _batch_losses(model, batch, cfg, rows, True, True, torch.float32)
    out.total.backward()
    pmesh.all_reduce_grads(model.parameters(), sh.group, average=True)
    loss = pmesh.all_reduce_sum(out.total.detach().clone(), sh.group) / sh.world
    grad = torch.cat([p.grad.reshape(-1) if p.grad is not None else torch.zeros(p.numel())
                      for p in model.parameters()])
    return {"loss": float(loss), "grad": grad.numpy().copy()}


def distill_case(mesh, loss: str = "reflow") -> dict:
    """One `distill_step` with SGD at lr 1: the loss, the pre-clip norm and
    the clipped reduced gradient."""
    from matcha_tts_tpu_torch.train import distill

    cfg = tiny_cfg()
    dcfg = distill.DistillConfig(loss=loss, nfe_teacher=2, learning_rate=1.0)
    teacher = MatchaTTS(cfg, seed=0, device="cpu")
    state = distill.create_distill_state(teacher, dcfg)
    state.optimizer = torch.optim.SGD(state.student.parameters(), lr=1.0)
    before = _flat(state.student)
    b = _local({k: v for k, v in global_batch().items() if k in ("x", "x_lengths")}, mesh)
    m = distill.distill_step(state, teacher, b["x"], b["x_lengths"], cfg, dcfg, FRAME_BUCKET,
                             seed=1, mesh=mesh)
    return {"loss": float(m["distill_loss"]), "grad_norm": float(m["grad_norm"]),
            "grad": before - _flat(state.student)}


def gan_case(mesh) -> dict:
    """One discriminator and generator step pair (a small HiFi-GAN against
    MSD) with SGD at lr 1: the losses and each update."""
    from matcha_tts_tpu_torch.train import vocoder as voc

    hcfg = C.HiFiGANConfig(upsample_initial_channel=16)
    state = voc.create_gan_state(hcfg, discriminators=("msd",), learning_rate=1.0,
                                 seed=0, device="cpu")
    for opt in (state.gen_opt, state.disc_opt):
        opt.adam = torch.optim.SGD(opt.params, lr=1.0)
    audio = np.random.default_rng(4).uniform(-0.5, 0.5, (4, 2048)).astype(np.float32)
    audio = _local({"audio": audio}, mesh)["audio"]
    g0, d0 = _flat(state.generator), _flat(state.discriminators)
    state, d_loss = voc.gan_disc_step(state, audio, C.AudioConfig(), mesh)
    d1 = _flat(state.discriminators)
    state, m = voc.gan_gen_step(state, audio, C.AudioConfig(), mesh)
    return {"disc_loss": float(d_loss), **{k: float(v) for k, v in m.items()},
            "disc_update": d0 - d1, "gen_update": g0 - _flat(state.generator)}


def fit_case(mesh, corpus: str, work: str) -> dict:
    """`fit` for 2 steps, then again to 3 (a resume)."""
    from matcha_tts_tpu_torch.train.loop import fit

    tcfg = C.TrainConfig(batch_size=2, mixed_precision=False, seed=3, log_every_n_steps=1,
                         ckpt_every_n_steps=100)
    fl = [str(Path(corpus) / n) for n in ("train.txt", "val.txt")]
    first = fit(tiny_cfg(), tcfg, *fl, work_dir=work, max_steps=2, device="cpu", mesh=mesh)
    second = fit(tiny_cfg(), tcfg, *fl, work_dir=work, max_steps=3, device="cpu", mesh=mesh)
    return {"steps": (first.step, second.step), "params": _flat(second.model)}


def vocoder_cli_case(mesh, corpus: str, work: str) -> dict:
    """`vocoder_cli --debug_tiny` for 2 steps (`--data_parallel` with a mesh)."""
    from matcha_tts_tpu_torch.train import vocoder_cli

    argv = ["--data_root", corpus, "--train_filelist", str(Path(corpus) / "train.txt"),
            "--family", "vocos", "--debug_tiny", "--discriminators", "mrd",
            "--batch_size", "2", "--segment_size", "2048", "--steps", "2", "--log_every", "1",
            "--work_dir", work, "--device", "cpu"]
    if mesh is not None:
        argv += ["--data_parallel", "--backend", "gloo"]
    state = vocoder_cli.main(argv)
    return {"step": state.step, "gen": _flat(state.generator)}


def in_background(world: int, fn, args=(), deadline_s: float = 120.0):
    """`spawn` on a thread of its own: a Future of the ranks' results, so
    that the test process computes its references meanwhile."""
    from concurrent.futures import ThreadPoolExecutor

    from matcha_tts_tpu_torch.parallel.launch import spawn

    pool = ThreadPoolExecutor(1)
    future = pool.submit(spawn, fn, world, "gloo", "cpu", deadline_s, args)
    pool.shutdown(wait=False)
    return future


def signal_case(mesh, corpus: str, work: str) -> int:
    """`fit` for up to 5 steps, in which rank 1 alone gets a SIGTERM after
    step 1: the step at which this rank stopped."""
    import os
    import signal

    from matcha_tts_tpu_torch.train import loop

    tcfg = C.TrainConfig(batch_size=2, mixed_precision=False, seed=3, ckpt_every_n_steps=100)
    real = loop.train_step

    def step_then_signal(state, *args, **kwargs):
        out = real(state, *args, **kwargs)
        if torch.distributed.get_rank() == 1 and state.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    loop.train_step = step_then_signal
    try:
        fl = [str(Path(corpus) / n) for n in ("train.txt", "val.txt")]
        return loop.fit(tiny_cfg(), tcfg, *fl, work_dir=work, max_steps=5, device="cpu",
                        mesh=mesh).step
    finally:
        loop.train_step = real


def distill_cli_case(mesh, work: str, teacher: str) -> np.ndarray:
    """The distillation CLI for 2 steps from the small trained teacher
    (`--chips 2` with a mesh): the saved student's parameters."""
    from matcha_tts_tpu_torch.train import distill
    from matcha_tts_tpu_torch.train.loop import Checkpointer

    argv = ["--teacher", teacher, "--steps", "2", "--batch_size", "2", "--nfe-teacher", "2",
            "--frame_bucket", "128", "--work_dir", work, "--device", "cpu"]
    if mesh is not None:
        argv += ["--chips", "2", "--backend", "gloo"]
        distill.main(argv)
        torch.distributed.barrier()  # rank 0's checkpoint is on disk
    else:
        distill.main(argv)
    return _flat(Checkpointer(f"{work}/ckpt").load_model(device="cpu"))


def trainers_rank(rank: int, corpus: str, work: str, teacher: str) -> dict:
    """Every trainer case at world 2, and the mesh helpers."""
    quiet_rank()
    mesh = pmesh.make_mesh(backend="gloo", device="cpu")
    out = {"names": tuple(mesh.mesh_dim_names), "sharding": pmesh.batch_sharding(mesh).rank}
    for fn, kw in ((pmesh.make_mesh, {"n_devices": 3}),
                   (pmesh.make_multislice_mesh, {"n_slices": 3})):
        try:
            fn(**kw)
        except ValueError as e:
            out[fn.__name__] = str(e)
    out["train"] = train_case(mesh)
    out["per_rank_mean"] = per_rank_mean_case(mesh)
    out["distill"] = distill_case(mesh)
    out["consistency"] = distill_case(mesh, "consistency")
    out["gan"] = gan_case(mesh)
    out["fit"] = fit_case(mesh, corpus, work + "/fit")
    out["vocoder_cli"] = vocoder_cli_case(mesh, corpus, work + "/voc")
    out["distill_cli"] = distill_cli_case(mesh, work + "/distill", teacher)
    out["signal"] = signal_case(mesh, corpus, work + "/signal")
    return out


def multislice_case(mesh, b: int = 8) -> dict:
    from matcha_tts_tpu_torch.train.train_state import TrainState, train_step

    cfg = tiny_cfg()
    tcfg = C.TrainConfig(batch_size=b, mixed_precision=False, seed=3, learning_rate=1.0)
    model = MatchaTTS(cfg, seed=0, device="cpu")
    before = _flat(model)
    state = TrainState(0, model, torch.optim.SGD(model.parameters(), lr=1.0))
    m = train_step(state, _local(global_batch(b), mesh), cfg, tcfg, mesh)
    return {"loss": float(m["loss"]), "grad": before - _flat(model)}


def multislice_rank(rank: int) -> dict:
    """World 4: the 2 x 2 ("dcn", "data") mesh's step, and the 2-D mesh."""
    quiet_rank()
    ms = pmesh.make_multislice_mesh(2, backend="gloo", device="cpu")
    sh = pmesh.batch_sharding(ms)
    m2 = pmesh.batch_sharding(pmesh.make_mesh_2d(2, 2))
    try:
        pmesh.make_multislice_mesh(3)
        err = None
    except ValueError as e:
        err = str(e)
    return {"names": tuple(ms.mesh_dim_names), "rows": (sh.rank, sh.world),
            "rows_2d": (m2.rank, m2.world), "error": err, "step": multislice_case(ms)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def synthesizer(weights, **kw):
    """A CPU `Synthesizer` over (port MatchaConfig, port HiFiGANConfig,
    {"matcha": tree, "vocoder": tree}) numpy trees."""
    from matcha_tts_tpu_torch.inference.synthesizer import Synthesizer
    from matcha_tts_tpu_torch.params.from_jax import load_jax_tree

    tc, th, trees = weights
    model, voc = load_jax_tree(trees, tc, th, device="cpu")
    return Synthesizer(model, tc, voc, th, device="cpu", **kw)


def _rows(results):
    return [{"pcm16": r.pcm16.copy(), "y_length": r.y_length} for r in results]


def serving_rank(rank: int, weights, spk_weights, kw, texts, long_text, mel):
    """World 2: the sharded batch (temperature 0 and 0.667, with `spk`),
    `synthesize_long(mesh=)`, `pod_vocode` and `TTSServer(mesh=)`."""
    from matcha_tts_tpu_torch.inference.pod_vocoder import pod_vocode

    quiet_rank()
    mesh = pmesh.make_mesh(backend="gloo", device="cpu")
    syn = synthesizer(weights, **kw)
    t0 = syn.synthesize_batch_sharded(texts, mesh, n_timesteps=2, temperature=0.0)
    out = {"t0": _rows(t0), "aux": [(r.mel, r.attn) for r in t0[:3]],
           "t667": _rows(syn.synthesize_batch_sharded(texts, mesh, n_timesteps=2, seed=7))}
    spk_syn = synthesizer(spk_weights, **kw)
    out["spk"] = {s: _rows(spk_syn.synthesize_batch_sharded(texts[:4], mesh, n_timesteps=2,
                                                            temperature=0.0, spk=s))
                  for s in (0, 2)}
    out["long"] = syn.synthesize_long(long_text, mesh=mesh, n_timesteps=2,
                                      temperature=0.0).wav
    out["pod"] = pod_vocode(syn.vocoder, torch.from_numpy(mel), mesh, syn.hifi_cfg).numpy()
    out["server"] = _serve(syn, mesh, rank, texts[:2])
    return out


def _serve(syn, mesh, rank, texts):
    """Two concurrent requests to rank 0's server; the WAV bodies."""
    from matcha_tts_tpu_torch.inference.server import TTSServer, follow

    if rank != 0:
        follow(syn, mesh)
        return None
    srv = TTSServer(syn, port=0, batch_window_ms=200.0, mesh=mesh).start()
    bodies = [None] * len(texts)

    def post(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/synthesize",
            data=('{"text": "%s", "n_timesteps": 2, "temperature": 0.0}' % texts[i]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            bodies[i] = r.read()

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stats = dict(srv.batcher.stats)
    srv.stop()
    return {"bodies": bodies, "stats": stats}


def pod_rank(rank: int, weights, mel):
    """World 4: `pod_vocode` and its two refusals."""
    from matcha_tts_tpu_torch.inference.pod_vocoder import pod_vocode
    from matcha_tts_tpu_torch.params.from_jax import load_jax_tree

    quiet_rank()
    mesh = pmesh.make_mesh(backend="gloo", device="cpu")
    tc, th, trees = weights
    _, voc = load_jax_tree({"vocoder": trees["vocoder"]}, tc, th, device="cpu")
    out = {"pod": pod_vocode(voc, torch.from_numpy(mel), mesh, th).numpy()}
    for t in (mel.shape[0] + 2, 4 * 8):
        try:
            pod_vocode(voc, torch.zeros(t, th.num_mels), mesh, th)
        except ValueError as e:
            out[t] = str(e)
    return out


def failing_rank(rank: int, how: str):
    """Rank 1 raises ("raise") or sleeps ("hang") while rank 0 waits for it
    in a barrier."""
    if rank == 1:
        if how == "raise":
            raise ValueError("rank 1 raised")
        time.sleep(600)
    torch.distributed.barrier()
