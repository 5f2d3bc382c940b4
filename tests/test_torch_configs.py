"""repro_torch.configs against repro.configs: every field of every full,
reduced and variant config, with the dtype mapped (jnp.bfloat16 ->
torch.bfloat16, the reduced configs' "float32" -> torch.float32)."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro import configs as JC
from repro_torch import configs as TC

DTYPE_MAP = {jnp.bfloat16: torch.bfloat16, "float32": torch.float32}


def _port_only_defaults(cls, ref_cls):
    """The port's fields that the reference's dataclass lacks, with their
    defaults."""
    ref = {f.name for f in dataclasses.fields(ref_cls)}
    return {f.name: f.default for f in dataclasses.fields(cls) if f.name not in ref}


def _same(jcfg, tcfg):
    """Every field the reference has is equal; every port-only field (latent
    attention, YaRN, leading dense layers, sigmoid routing, expert
    parallelism) holds its default, under which the reference's families
    behave, initialise and count exactly as before."""
    jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert DTYPE_MAP[jd.pop("dtype")] == td.pop("dtype")
    for key, default in _port_only_defaults(type(tcfg), type(jcfg)).items():
        assert td.pop(key) == default, key
    if jcfg.moe is not None:
        for key, default in _port_only_defaults(type(tcfg.moe), type(jcfg.moe)).items():
            assert td["moe"].pop(key) == default, key
    assert td == jd
    assert tcfg.n_params() == jcfg.n_params()
    assert tcfg.n_active_params() == jcfg.n_active_params()
    assert tcfg.layer_flags() == jcfg.layer_flags()
    assert tcfg.head_dim_ == jcfg.head_dim_


def test_registry():
    assert TC.ARCH_IDS == JC.ARCH_IDS
    assert [(a, s.name) for a, s in TC.all_dryrun_pairs()] == \
        [(a, s.name) for a, s in JC.all_dryrun_pairs()]
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_full_and_reduced_configs(arch):
    _same(JC.get_config(arch), TC.get_config(arch))
    _same(JC.get_config(arch, reduced=True), TC.get_config(arch, reduced=True))
    assert TC.get_config(arch).dtype == torch.bfloat16
    assert TC.get_config(arch, reduced=True).dtype == torch.float32


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_variant_families(arch):
    jfam, tfam = JC.get_variant_family(arch), TC.get_variant_family(arch)
    assert [(n, a) for n, _, a in tfam] == [(n, a) for n, _, a in jfam]
    for (_, jcfg, _), (_, tcfg, _) in zip(jfam, tfam):
        _same(jcfg, tcfg)
