"""The port's weight carrier against the JAX package's exporter.

``params_from_jax`` on a flax parameter tree converted to numpy must give
the same keys and the same values (exactly: both only reorder and transpose
f32 arrays) as ``diverse_channel_vit_tpu.models.export.channelvit_model_params``,
and the result must load into the port's model with ``strict=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diverse_channel_vit_tpu.models.channel_vit import ChannelVisionTransformer as JBackbone
from diverse_channel_vit_tpu.models.export import channelvit_model_params
from diverse_channel_vit_tpu.models.wrappers import ChannelAdaptiveClassifier as JClassifier
from diverse_channel_vit_torch.config import Config
from diverse_channel_vit_torch.models import build_model
from diverse_channel_vit_torch.models.export import params_from_jax

C, IMG, PATCH, D, NC = 3, 32, 16, 64, 4


def _jax_params(scan_blocks=False, with_head=True):
    model = JClassifier(
        backbone=JBackbone(num_total_channels=C, img_size=IMG, patch_size=PATCH, embed_dim=D,
                           depth=2, num_heads=2, proxy_loss_lambda=1e-3,
                           scan_blocks=scan_blocks),
        embed_dim=D, num_classes=NC, with_head=with_head, learnable_temp=True,
    )
    x = jnp.zeros((1, C, IMG, IMG), jnp.float32)
    params = model.init({"params": jax.random.key(1)}, x, jnp.arange(C), train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(with_head=True):
    cfg = Config({"in_channel_names": ["a", "b", "c"], "img_size": [IMG], "patch_size": PATCH,
                  "pretrained_model_name": "test", "embed_dim": D, "proxy_loss_lambda": 1e-3,
                  "learnable_temp": True})
    mapper = {"JUMP-CP": [0, 1, 2]} if with_head else {"Allen": [0, 1, 2]}
    return build_model("dichavit", cfg, mapper, NC, device="cpu")


@pytest.mark.parametrize("scan_blocks", [False, True])
@pytest.mark.parametrize("with_head", [True, False])
def test_carrier_matches_jax_exporter_and_loads_strict(scan_blocks, with_head):
    params = _jax_params(scan_blocks, with_head)
    got = params_from_jax(params)
    jax_layout = params
    if scan_blocks:
        # flax nests the scan as blocks/blocks/block; the JAX exporter reads
        # blocks/block, so it gets the same leaves one level up
        bb = dict(params["backbone"], blocks=params["backbone"]["blocks"]["blocks"])
        jax_layout = dict(params, backbone=bb)
    want = channelvit_model_params(jax_layout)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    model = _port_model(with_head)
    model.load_state_dict(got, strict=True)
    assert torch.equal(model.proxies, model.adaptive_interface[0])


def test_build_model_checks_channel_ids():
    cfg = Config({"in_channel_names": ["a", "b"], "img_size": [IMG], "patch_size": PATCH,
                  "pretrained_model_name": "test"})
    with pytest.raises(ValueError, match="out of range"):
        build_model("dichavit", cfg, {"x": [0, 2]}, NC, device="cpu")
    with pytest.raises(KeyError):
        build_model("no_such_model", cfg, {}, NC, device="cpu")


def test_build_model_is_seeded():
    a, b = _port_model().state_dict(), _port_model().state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
