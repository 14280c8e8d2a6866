"""Ahead-of-time export of the packed synthesis graph (`torch.export`).

A service wants a frozen program per compiled shape that reloads in a fresh
process without retracing the Python model code.  `torch.export.export`
(non-strict) traces the eager call of `Synthesizer._synthesize_packed` for
one (batch, text bucket, frame bucket) into an ATen graph, and
`torch.export.save` writes it as a `.pt2`; `torch.export.load` gives it back
as a callable.  The kernels stay kernels: while tracing, every kernel
wrapper on the serving path calls a `torch.library` op (`matcha_torch::mrf`,
`mrf_up`, `mrf_tap`, `attention`, `block1d`, `resnet1d`; `ops/*_cuda.py`,
`ops/kernel_op.py`), which the graph records as one node, so that a replay on the card launches the
hand-written kernels (and counts them in the modules' `LAUNCHES`) and a
replay on the CPU runs their plain versions.  No AOTInductor and no
`torch.compile`: a loaded artifact runs the exported ATen graph and the
registered ops.  This module imports the op modules, so that loading an
artifact finds its ops; without them `torch.export.load` fails.

The parameters are *call-time arguments* (an artifact holds the graph, not
the weights), so one artifact serves any checkpoint with the same module
tree.  The exported callable's signature is

    (matcha_params, vocoder_params, z, x, x_lengths[, bias_spec])
        -> (packed_int16, mel, attn, durations, y_lengths)

where the params are the modules' `state_dict()`s (threaded through
`torch.func.functional_call`), `z` (batch, frame_bucket, n_feats) fp32 is
the CFM noise (a `torch.Generator` cannot live in a graph: `noise(seed,
...)` draws what the eager call draws for that seed), `x` (batch,
text_bucket) int64 token ids, `x_lengths` (batch,) int64, and the packed
buffer is laid out as `synthesizer.pack_pcm` packs it.  With
`denoise_strength > 0` the denoiser runs in the graph on the call-time
`bias_spec` (`make_denoiser(vocoder, cfg).bias_spec`).  Host reads of the
lengths stay outside the graph: the caller picks the frame bucket
(`Synthesizer.predict_frame_bucket`) and retries one bucket up when a
returned y_length fills it; the graph clamps y_lengths to its bucket.  An
artifact is traced for one device (the manifest's "device"): its tensor
constants live there.

Layout on disk (`export_bucket_grid`):

    out_dir/
      manifest.json            {"format": ..., "device": ..., "entries": [...]}
      synth_b1_t128_f512.pt2   torch.export.save of one ExportedProgram
      ...
"""

from __future__ import annotations

import collections
import io
import json
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from matcha_tts_tpu_torch.config import MatchaConfig, VocosConfig
from matcha_tts_tpu_torch.inference.synthesizer import pack_pcm
from matcha_tts_tpu_torch.models import cfm
from matcha_tts_tpu_torch.models.denoiser import DenoiserState
from matcha_tts_tpu_torch.models.matcha import as_dtype
# the op modules register the kernels' ops, which an artifact names
from matcha_tts_tpu_torch.ops import attn_cuda, mrf_cuda, unet_cuda  # noqa: F401

FORMAT = "matcha-tpu-torch-export-v1"
OP_NAMESPACE = "matcha_torch"


class _Undecorated(nn.Module):
    """`module`'s forward without its `torch.no_grad()` decorator, as a
    module for `functional_call`: the export runs under no_grad already, and
    each grad-mode switch in a traced call makes torch.export split the
    graph around it (a pass that doubles a small graph's export time)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module
        forward = type(module).forward
        self._fn = getattr(forward, "__wrapped__", forward)

    def forward(self, *args, **kwargs):
        return self._fn(self.module, *args, **kwargs)

    def call(self, params: Dict[str, torch.Tensor], *args, **kwargs):
        """The forward on `params` (the module's `state_dict()` names), every
        one of them given: none of the module's own weights enters the graph."""
        return functional_call(self, {f"module.{k}": v for k, v in params.items()},
                               args, kwargs, strict=True)


class _PackedSynthesis(nn.Module):
    """The graph that is exported: `Synthesizer._synthesize_packed` at one
    frame bucket, on parameters given at call time.  The model and the
    vocoder are held outside the module tree, so that export lifts none of
    their weights into the artifact."""

    def __init__(self, model, matcha_cfg: MatchaConfig, vocoder, hifi_cfg, *,
                 frame_bucket: int, n_timesteps: int, temperature: float,
                 length_scale: float, compute_dtype: str, denoise_strength: float):
        super().__init__()
        self._held = (_Undecorated(model), _Undecorated(vocoder))
        self.matcha_cfg, self.hifi_cfg = matcha_cfg, hifi_cfg
        self.frame_bucket, self.n_timesteps = frame_bucket, n_timesteps
        self.temperature, self.length_scale = temperature, length_scale
        self.dtype = as_dtype(compute_dtype)
        self.denoise_strength = denoise_strength

    def forward(self, matcha_params, vocoder_params, z, x, x_lengths, *maybe_bias):
        model, vocoder = self._held
        out = model.call(matcha_params, x, x_lengths, n_timesteps=self.n_timesteps,
                         t_y_max=self.frame_bucket, temperature=self.temperature,
                         length_scale=self.length_scale, compute_dtype=self.dtype, z=z)
        mel_btc = out.mel.transpose(1, 2).to(self.dtype)
        args = (mel_btc,) if isinstance(self.hifi_cfg, VocosConfig) else (mel_btc, self.hifi_cfg)
        wav = vocoder.call(vocoder_params, *args)
        denoiser = DenoiserState(maybe_bias[0]) if maybe_bias else None
        packed = pack_pcm(wav, out.y_lengths, denoiser, self.denoise_strength)
        return packed, out.mel, out.attn, out.durations, out.y_lengths


def noise(seed: int, batch: int, frame_bucket: int, n_feats: int, device="cuda") -> torch.Tensor:
    """The exported graphs' `z`: exactly what the eager call draws for `seed`
    without per-row noise ids (`models/cfm.py::draw_noise`), fp32 (batch,
    frame_bucket, n_feats)."""
    return cfm.draw_noise((batch, frame_bucket, n_feats), torch.device(device), seed)


def _example_inputs(model, matcha_cfg, vocoder, batch, text_bucket, frame_bucket, device,
                    denoise: bool):
    """Example arguments of the shapes the graph is traced at; with `denoise`
    a zero bias spectrum of `DenoiserState`'s default geometry (the bias is a
    call-time argument: only its shape is traced)."""
    x = torch.ones((batch, text_bucket), dtype=torch.long, device=device)
    x_lengths = torch.full((batch,), text_bucket, dtype=torch.long, device=device)
    z = torch.zeros((batch, frame_bucket, matcha_cfg.encoder.n_feats), device=device)
    args = (model.state_dict(), vocoder.state_dict(), z, x, x_lengths)
    if not denoise:
        return args
    return args + (torch.zeros((DenoiserState(None).filter_length // 2 + 1, 1), device=device),)


def export_program(model, matcha_cfg: MatchaConfig, vocoder, hifi_cfg, *, batch: int = 1,
                   text_bucket: int = 128, frame_bucket: int = 512, n_timesteps: int = 10,
                   temperature: float = 0.667, length_scale: float = 1.0,
                   compute_dtype: str = "bfloat16", denoise_strength: float = 0.0,
                   device=None) -> torch.export.ExportedProgram:
    """Trace one (batch, text, frame) packed-synthesis graph on `device` (by
    default the model's); the `ExportedProgram`, unsaved.  With
    `denoise_strength > 0` the graph takes a `bias_spec` argument."""
    device = torch.device(device) if device is not None else model.device
    model, vocoder = model.to(device), vocoder.to(device)
    graph = _PackedSynthesis(model, matcha_cfg, vocoder, hifi_cfg, frame_bucket=frame_bucket,
                             n_timesteps=n_timesteps, temperature=temperature,
                             length_scale=length_scale, compute_dtype=compute_dtype,
                             denoise_strength=denoise_strength)
    args = _example_inputs(model, matcha_cfg, vocoder, batch, text_bucket, frame_bucket,
                           device, denoise_strength > 0.0)
    with torch.no_grad():
        return torch.export.export(graph, args, strict=False)


def export_synthesis(model, matcha_cfg: MatchaConfig, vocoder, hifi_cfg, **kw) -> bytes:
    """`export_program`, serialised (`torch.export.save`): the `.pt2` bytes.
    The arguments are `export_program`'s; the callable that
    `load_synthesis` gives back has the signature in the module docstring."""
    program = export_program(model, matcha_cfg, vocoder, hifi_cfg, **kw)
    # the example inputs hold the weights it was traced with: not saved
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_synthesis(data: bytes) -> Callable:
    """Deserialise an exported graph (`.pt2` bytes); returns the callable (see
    the module docstring for its arguments)."""
    return torch.export.load(io.BytesIO(data)).module()


def kernel_ops(program) -> Dict[str, int]:
    """{op name: nodes} of the registered kernel ops (`matcha_torch::*`) in an
    `ExportedProgram` or a `GraphModule`, nested graphs included."""
    gm = program.graph_module if hasattr(program, "graph_module") else program
    counts: Dict[str, int] = collections.Counter()
    for sub in gm.modules():
        graph = getattr(sub, "graph", None)
        if graph is None:
            continue
        for node in graph.nodes:
            name = getattr(node.target, "name", None)
            if node.op == "call_function" and callable(name):
                name = name()
            if isinstance(name, str) and name.startswith(OP_NAMESPACE + "::"):
                counts[name.split("::", 1)[1].split(".")[0]] += 1
    return dict(counts)


def export_bucket_grid(model, matcha_cfg: MatchaConfig, vocoder, hifi_cfg, out_dir, *,
                       batch_buckets: Sequence[int] = (1,),
                       text_buckets: Sequence[int] = (128, 256),
                       frame_buckets: Sequence[int] = (256, 512, 768),
                       n_timesteps: int = 10, compute_dtype: str = "bfloat16",
                       device=None, **kw) -> dict:
    """Export a serving grid of graphs and its manifest.json into `out_dir`;
    returns the manifest."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    device = torch.device(device) if device is not None else model.device
    entries = []
    for b in batch_buckets:
        for t in text_buckets:
            for f in frame_buckets:
                name = f"synth_b{b}_t{t}_f{f}.pt2"
                data = export_synthesis(model, matcha_cfg, vocoder, hifi_cfg, batch=b,
                                        text_bucket=t, frame_bucket=f,
                                        n_timesteps=n_timesteps,
                                        compute_dtype=compute_dtype, device=device, **kw)
                (out / name).write_bytes(data)
                entries.append({"batch": b, "text": t, "frames": f, "file": name,
                                "n_timesteps": n_timesteps, "compute_dtype": compute_dtype})
    manifest = {
        "format": FORMAT,
        "device": str(device),
        "sample_rate": matcha_cfg.audio.sample_rate,
        "hop_length": matcha_cfg.audio.hop_length,
        "entries": entries,
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return manifest


def load_bucket_grid(out_dir) -> Dict[Tuple[int, int, int], Callable]:
    """Load a manifest directory into {(batch, text, frames): callable}."""
    out = Path(out_dir)
    manifest = json.loads((out / "manifest.json").read_text())
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{out}: format {manifest.get('format')!r}, expected {FORMAT!r}")
    return {(e["batch"], e["text"], e["frames"]): load_synthesis((out / e["file"]).read_bytes())
            for e in manifest["entries"]}


def unpack_pcm(packed, batch: int, hop_length: int):
    """Split the flat int16 buffer back into (pcm (B, T_wav), y_lengths)."""
    packed = packed.cpu().numpy() if isinstance(packed, torch.Tensor) else np.asarray(packed)
    y_lengths = packed[-batch:].astype(np.int32)
    pcm = packed[:-batch].reshape(batch, -1)
    return pcm, y_lengths
