"""The port's model configs (``repro_torch.configs``) and precision policy
(``repro_torch.models.policy``) are the JAX package's, field for field."""

import dataclasses

import pytest
import torch

from repro import configs as jcfg
from repro.models import policy as jpolicy
from repro_torch import configs as tcfg
from repro_torch.models import policy as tpolicy


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["policy"] = dataclasses.asdict(cfg.policy)
    return out


def test_registry_matches():
    assert tcfg.ARCH_IDS == jcfg.ARCH_IDS
    assert tcfg.ARCH_ALIASES == jcfg.ARCH_ALIASES
    assert [f.name for f in dataclasses.fields(tcfg.ModelConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.ModelConfig)]


@pytest.mark.parametrize("arch", jcfg.ARCH_IDS)
def test_every_field_matches(arch):
    assert _fields(tcfg.get_config(arch)) == _fields(jcfg.get_config(arch))
    assert _fields(tcfg.get_smoke_config(arch)) == \
        _fields(jcfg.get_smoke_config(arch))
    full = tcfg.get_config(arch)
    assert full.head_dim() == jcfg.get_config(arch).head_dim()
    assert full.subquadratic == jcfg.get_config(arch).subquadratic


def test_aliases_resolve():
    assert tcfg.get_config("qwen1.5-0.5b") is tcfg.get_config("qwen1p5_0p5b")


def test_policies_match():
    for name in ("DEFAULT", "FULL_F32"):
        t, j = getattr(tpolicy, name), getattr(jpolicy, name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    p = tpolicy.DEFAULT
    assert (p.p(), p.c(), p.a(), p.k(), p.l(), p.comm()) == (
        torch.float32, torch.bfloat16, torch.float32, torch.bfloat16,
        torch.float32, torch.bfloat16)
    assert tpolicy.FULL_F32.c() == tpolicy.FULL_F32.k() == torch.float32
