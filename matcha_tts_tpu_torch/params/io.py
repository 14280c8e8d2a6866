"""Load a Matcha model from a training run or a checkpoint file: one entry
point for the CLI, the `Synthesizer` and the exporter.

A run is either the port's own layout (`train/loop.py::Checkpointer`:
`ckpt/step_XXXXXXXX.pt` with `index.json`, each file carrying the model's
config) or the JAX package's: an Orbax `CheckpointManager` directory, one
directory per step with the train state and the config, which
`params/orbax.py` reads without orbax, tensorstore or JAX, so a host that
serves or trains with the port needs none of them.  `load_matcha_any`
tells the two apart by what the directory holds.  A JAX tree in memory, or
one saved flat as `.npz`, loads through `params/from_jax.py`
(`load_jax_tree`, `read_npz`).
"""

from __future__ import annotations

from pathlib import Path
from typing import TYPE_CHECKING, Optional, Tuple

from matcha_tts_tpu_torch.config import MatchaConfig

if TYPE_CHECKING:
    from matcha_tts_tpu_torch.models.matcha import MatchaTTS


def load_run_matcha(work_or_ckpt_dir, step: Optional[int] = None,
                    device="cuda") -> Tuple["MatchaTTS", MatchaConfig]:
    """(model, config) from a run directory that `train/loop.py::fit` (or
    `train/distill.py`, whose student it is then) wrote, or its `ckpt/`:
    the latest checkpoint, or `step`, on `device`."""
    from matcha_tts_tpu_torch.train.loop import Checkpointer

    d = Path(work_or_ckpt_dir).absolute()
    if (d / "ckpt").exists():
        d = d / "ckpt"
    ckpt = Checkpointer(d, write=False)
    if ckpt.latest_step() is None:
        raise FileNotFoundError(f"no checkpoints under {d}")
    model = ckpt.load_model(step, device=device)
    return model, model.cfg


def load_orbax_matcha(work_or_ckpt_dir, step: Optional[int] = None,
                      device="cuda") -> Tuple["MatchaTTS", MatchaConfig]:
    """(model, config) from an Orbax run that the JAX package's trainers
    wrote (`train/loop.py::fit`, or `train/distill.py`, whose student is its
    `params`), or its `ckpt/`: the state's `params` and the `config` item of
    the latest step, or of `step`, on `device`."""
    from matcha_tts_tpu_torch.config import config_from_dict
    from matcha_tts_tpu_torch.params.from_jax import load_jax_tree
    from matcha_tts_tpu_torch.params.orbax import read_orbax_tree

    params, config = read_orbax_tree(work_or_ckpt_dir, step, subtree="params")
    if config is None:
        raise FileNotFoundError(f"{work_or_ckpt_dir}: the checkpoint has no config item")
    cfg = config_from_dict(MatchaConfig, config)
    model, _ = load_jax_tree({"matcha": params}, cfg, device=device)
    return model, cfg


def load_matcha_any(path, cfg: Optional[MatchaConfig] = None,
                    device="cuda") -> Tuple["MatchaTTS", MatchaConfig]:
    """Dispatch on the checkpoint's kind: a directory is a training run of
    the port (`load_run_matcha`, found by its `index.json`) or of the JAX
    package (`load_orbax_matcha`, found by its numbered step directories),
    a file a reference Lightning `.ckpt` (converted by
    `convert_matcha`, its config from the checkpoint's `hyper_parameters`
    where they carry one, else `cfg`, else `MatchaConfig()`)."""
    p = Path(path)
    if p.is_dir():
        from matcha_tts_tpu_torch.params.orbax import ckpt_dir, is_orbax_run

        if (ckpt_dir(p) / "index.json").is_file():
            return load_run_matcha(p, device=device)
        if is_orbax_run(p):
            return load_orbax_matcha(p, device=device)
        raise FileNotFoundError(
            f"{p} is not a training run: neither the port's (ckpt/index.json and "
            f"step_XXXXXXXX.pt files) nor an Orbax run of the JAX package (numbered step "
            f"directories holding _CHECKPOINT_METADATA)")
    from matcha_tts_tpu_torch.config import config_from_dict
    from matcha_tts_tpu_torch.params.convert import convert_matcha, load_torch_checkpoint
    from matcha_tts_tpu_torch.params.from_jax import load_jax_tree

    sd, hyper = load_torch_checkpoint(p)
    if cfg is None and isinstance(hyper, dict) and "encoder" in hyper:
        cfg = config_from_dict(MatchaConfig, hyper)
    cfg = cfg or MatchaConfig()
    model, _ = load_jax_tree({"matcha": convert_matcha(sd, cfg)}, cfg, device=device)
    return model, cfg
