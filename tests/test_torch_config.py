"""The port's copy of the presets (gan_sass_tf_tpu_torch.config) against
the JAX package's gan_sass_tf_tpu.config: every preset field for field, the
`--set` overrides of both CLIs, the JSON form and the fingerprint."""

import dataclasses

import pytest

from gan_sass_tf_tpu import cli as j_cli
from gan_sass_tf_tpu import config as j_config
from gan_sass_tf_tpu_torch import cli, config

OVERRIDES = ["model.g_channels=8,16", "train.batch_size=4", "dsp.n_mels=32",
             "model.compute_dtype=float32", "data.segment_seconds=0.5"]


def test_same_preset_names():
    assert config.list_configs() == j_config.list_configs()
    assert len(config.list_configs()) >= 5


@pytest.mark.parametrize("name", j_config.list_configs())
def test_preset_equals_the_jax_package(name):
    ours, ref = config.get_config(name), j_config.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.to_json() == ref.to_json()
    assert ours.fingerprint() == ref.fingerprint()


@pytest.mark.parametrize("name", ["wsj0_logmel", "music_complex_44k"])
def test_set_overrides_equal_in_both(name):
    ours = cli._apply_overrides(config.get_config(name), OVERRIDES)
    ref = j_cli._apply_overrides(j_config.get_config(name), OVERRIDES)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.model.g_channels == (8, 16) and ours.train.batch_size == 4


def test_port_config_is_its_own_module():
    assert config.__name__ == "gan_sass_tf_tpu_torch.config"
    assert config.Config is not j_config.Config
    with pytest.raises(KeyError, match="unknown config"):
        config.get_config("no_such_preset")
