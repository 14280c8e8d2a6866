"""Load a Matcha model from a training run or a checkpoint file: one entry
point for the CLI, the `Synthesizer` and the exporter.

A run is the port's own layout (`train/loop.py::Checkpointer`: `ckpt/
step_XXXXXXXX.pt` with `index.json`, each file carrying the model's config).
The JAX package's runs are Orbax directories, which the port does not read
(the card's machine has no orbax): the bridge from a JAX run is its tree
saved flat as `.npz`, which `params/from_jax.py::read_npz` reads and
`load_jax_tree` loads.
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


def load_matcha_any(path, cfg: Optional[MatchaConfig] = None,
                    device="cuda") -> Tuple["MatchaTTS", MatchaConfig]:
    """Dispatch on the checkpoint's kind: a directory is a training run
    (`load_run_matcha`), a file a reference Lightning `.ckpt` (converted by
    `convert_matcha`, its config from the checkpoint's `hyper_parameters`
    where they carry one, else `cfg`, else `MatchaConfig()`)."""
    p = Path(path)
    if p.is_dir():
        return load_run_matcha(p, device=device)
    from matcha_tts_tpu_torch.config import config_from_dict
    from matcha_tts_tpu_torch.params.convert import convert_matcha, load_torch_checkpoint
    from matcha_tts_tpu_torch.params.from_jax import load_jax_tree

    sd, hyper = load_torch_checkpoint(p)
    if cfg is None and isinstance(hyper, dict) and "encoder" in hyper:
        cfg = config_from_dict(MatchaConfig, hyper)
    cfg = cfg or MatchaConfig()
    model, _ = load_jax_tree({"matcha": convert_matcha(sd, cfg)}, cfg, device=device)
    return model, cfg
