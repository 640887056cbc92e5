from .configs import (ModelConfig, PYTHIA_70M, QWEN2_0_5B, QWEN2_1_5B,
                      LLAMA_3_2_1B, PRESETS, tiny_config)
from .transformer import (AttnStats, forward, run_layers, run_layers_from_ids,
                          embed, unembed, nll_from_logits, nll_tail, init_params,
                          precompute_rope, params_to)
from .hf_loader import params_from_state_dict, config_from_hf
from .convert import params_from_jax_numpy

__all__ = [
    "ModelConfig", "PYTHIA_70M", "QWEN2_0_5B", "QWEN2_1_5B", "LLAMA_3_2_1B",
    "PRESETS", "tiny_config",
    "AttnStats", "forward", "run_layers", "run_layers_from_ids", "embed",
    "unembed", "nll_from_logits", "nll_tail", "init_params", "precompute_rope",
    "params_to", "params_from_state_dict", "config_from_hf",
    "params_from_jax_numpy",
]
