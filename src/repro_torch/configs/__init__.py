"""Architecture registry: ``--arch <id>`` -> (full config, smoke config).

Copies of ``src/repro/configs/``, on the port's ``ModelConfig``.  Every
architecture is registered; ``models.lm.build_model`` builds the dense
family and names the ROADMAP item that ports each other one.
"""

from importlib import import_module

ARCHS = {
    "whisper-small": "whisper_small",
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-3-2b": "granite_3_2b",
    "qwen2-7b": "qwen2_7b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "grok-1-314b": "grok_1_314b",
    "xlstm-125m": "xlstm_125m",
    "zamba2-1.2b": "zamba2_1_2b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
}


def get_config(arch: str, smoke: bool = False):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    mod = import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_archs():
    return list(ARCHS)
