#!/usr/bin/env python3
"""Write `tests/golden/orbax_small/`: an Orbax training run of the JAX package
that the port reads with `params/orbax.py` on a machine without JAX.

    JAX_PLATFORMS=cpu python3 tools/make_orbax_fixture.py [--out DIR] [--full-width]

It needs the JAX package and orbax (it imports `matcha_tts_tpu`); neither
`chip_smoke.py` nor the port imports it.  It writes, under DIR:

* `ckpt/`: what `matcha_tts_tpu.train.loop.fit` writes, through the same
  `Checkpointer` (best-k on "loss"): a `TrainState` with Adam's state at
  steps 1 and 2, each after one Adam update on gradients drawn from a seed,
  so the two steps hold different params;
* `params_step<N>.npz`: each step's params saved flat with "/"-joined keys
  (`params/from_jax.py::read_npz`'s convention), from the state in memory;
* `config.json`: the model config (`config_to_dict`).

The config is small (one encoder layer of 8 channels, one decoder level of
8) but keeps 80 mel channels, so `HiFiGANConfig()` takes its output; the
directory holds about 1.8 MB, most of it Orbax's per-leaf metadata.  With
`--full-width` the run is of `MatchaConfig()` instead (about 220 MB a step,
not committed), for `tools/orbax_read_time.py`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

STEPS = (1, 2)


def fixture_config():
    from matcha_tts_tpu.config import (DecoderConfig, DurationPredictorConfig, EncoderConfig,
                                       MatchaConfig)

    return MatchaConfig(
        encoder=EncoderConfig(n_feats=80, n_channels=8, filter_channels=16, n_heads=2,
                              n_layers=1, p_dropout=0.0),
        duration_predictor=DurationPredictorConfig(filter_channels_dp=16),
        decoder=DecoderConfig(channels=(8,), attention_head_dim=8, num_heads=1,
                              n_blocks=1, num_mid_blocks=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(REPO / "tests" / "golden" / "orbax_small"))
    ap.add_argument("--full-width", action="store_true",
                    help="MatchaConfig() instead of the small config")
    args = ap.parse_args()

    import jax
    import numpy as np
    import optax

    jax.config.update("jax_platforms", "cpu")
    from matcha_tts_tpu.config import MatchaConfig, TrainConfig, config_to_dict
    from matcha_tts_tpu.models.matcha import init_matcha
    from matcha_tts_tpu.train.loop import Checkpointer
    from matcha_tts_tpu.train.train_state import TrainState, create_train_state, make_optimizer
    from matcha_tts_tpu_torch.params.from_jax import flatten_tree

    out = Path(args.out)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    cfg, tcfg = MatchaConfig() if args.full_width else fixture_config(), TrainConfig()
    state = create_train_state(init_matcha(jax.random.PRNGKey(0), cfg), tcfg)
    tx = make_optimizer(tcfg)
    rng = np.random.default_rng(21)
    ckpt = Checkpointer(out / "ckpt", keep=tcfg.ckpt_keep, monitor="loss")
    for step in STEPS:
        grads = jax.tree_util.tree_map(
            lambda p: np.asarray(rng.standard_normal(p.shape), np.float32), state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        state = TrainState(step=state.step + 1, params=optax.apply_updates(state.params, updates),
                           opt_state=opt_state)
        assert int(state.step) == step
        ckpt.save(step, state, cfg, metrics={"loss": 1.0 / step})
        flat = flatten_tree(jax.device_get(state.params))
        np.savez(out / f"params_step{step}.npz", **{k.replace(".", "/"): v for k, v in flat.items()})
    (out / "config.json").write_text(json.dumps(config_to_dict(cfg), indent=1, sort_keys=True))
    size = sum(p.stat().st_size for p in out.rglob("*") if p.is_file())
    print(f"wrote {out}: steps {STEPS}, {size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
