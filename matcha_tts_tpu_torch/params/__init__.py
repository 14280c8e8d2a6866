"""Parameter interop: reference checkpoints into the JAX package's trees and
back, those trees into the port's modules, and the loaders of a training run
(the port's or the JAX package's Orbax run) or a checkpoint file."""

from matcha_tts_tpu_torch.params.convert import (  # noqa: F401
    convert_hifigan,
    convert_matcha,
    convert_vocos,
    export_matcha,
    export_vocos,
    fold_weight_norm,
    load_torch_state_dict,
    vocos_config_from_state_dict,
)
from matcha_tts_tpu_torch.params.io import (  # noqa: F401
    load_matcha_any,
    load_orbax_matcha,
    load_run_matcha,
)
from matcha_tts_tpu_torch.params.orbax import read_orbax_tree  # noqa: F401
