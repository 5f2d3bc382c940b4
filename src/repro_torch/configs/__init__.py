"""Config registry: the 10 assigned architectures + the paper's pipelines."""
from repro_torch.configs import (
    gemma3_27b,
    jamba_v0p1_52b,
    kimi_k2_1t_a32b,
    mamba2_2p7b,
    phi3_vision_4p2b,
    qwen2_moe_a2p7b,
    starcoder2_15b,
    starcoder2_3b,
    whisper_medium,
    yi_34b,
)
from repro_torch.configs.base import (
    DECODE_32K,
    INPUT_SHAPES,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

_ARCH_MODULES = {
    m.ARCH_ID: m
    for m in (
        gemma3_27b,
        mamba2_2p7b,
        whisper_medium,
        starcoder2_3b,
        starcoder2_15b,
        phi3_vision_4p2b,
        kimi_k2_1t_a32b,
        qwen2_moe_a2p7b,
        yi_34b,
        jamba_v0p1_52b,
    )
}

ARCH_IDS = tuple(_ARCH_MODULES)


def arch_module(arch_id: str):
    try:
        return _ARCH_MODULES[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")


def get_config(arch_id: str, *, reduced: bool = False) -> ModelConfig:
    mod = arch_module(arch_id)
    return mod.reduced() if reduced else mod.full()


def get_variant_family(arch_id: str):
    return arch_module(arch_id).variant_family()


# Which input shapes apply to which architecture (see DESIGN.md §4).
_SUBQUADRATIC_DECODE = {
    # archs whose long-context cache is sub-quadratic / bounded:
    "mamba2-2.7b",        # O(1) SSM state
    "jamba-v0.1-52b",     # mamba layers O(1); 1:7 attn layers keep KV
    "gemma3-27b",         # 5:1 local(window 1024):global
    "starcoder2-3b",      # sliding-window 4096, all layers
    "starcoder2-15b",     # sliding-window 4096, all layers
}


def shapes_for_arch(arch_id: str):
    """The input shapes this architecture must lower for (see DESIGN.md)."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if arch_id in _SUBQUADRATIC_DECODE:
        shapes.append(LONG_500K)
    return shapes


def all_dryrun_pairs():
    return [(a, s) for a in ARCH_IDS for s in shapes_for_arch(a)]
