"""The port's configuration dataclasses against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import butterfly_tpu_torch
from butterfly_tpu import config as jconfig
from butterfly_tpu_torch import config as tconfig


def test_device_config_is_exported_with_its_defaults():
    assert butterfly_tpu_torch.DeviceConfig is tconfig.DeviceConfig
    assert "DeviceConfig" in butterfly_tpu_torch.__all__
    cfg = tconfig.DeviceConfig()
    assert (cfg.dtype, cfg.block_pad, cfg.use_kernel) == (torch.float32, 128,
                                                          True)
    jcfg = jconfig.DeviceConfig()
    assert cfg.block_pad == jcfg.block_pad
    assert cfg.use_kernel == jcfg.use_pallas
    assert np.dtype(str(cfg.dtype).removeprefix("torch.")) == jcfg.dtype
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.block_pad = 64
    assert tconfig.DeviceConfig(torch.bfloat16, 64, False).dtype is \
        torch.bfloat16


def test_fac_spec_defaults_match_jax():
    t = tconfig.FacSpec(None, None)
    j = jconfig.FacSpec(None, None)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
