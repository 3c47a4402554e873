"""DINOv2 in the port (``diverse_channel_vit_torch/models/dinov2.py``)
against the JAX package's and torch, on the CPU.

- The positional resampling tables: the hub ``*_reg`` setting (size-based,
  antialiased: ``offset`` 0, a = -0.5, taps clipped and renormalised) and
  the plain backbones' (``offset`` 0.1, no antialias, a = -0.75) against
  ``F.interpolate(..., mode="bicubic", antialias=...)`` of the same grid,
  down- and up-scaling, within 1e-5 of max|value| (at the native grid the
  table itself); the tables themselves against JAX's, within 1e-6.
- The forward: a small DINOv2 (D = 64, 2 heads, depth 2, patch 14, 4
  registers, the published 37 x 37 grid resampled to 3 x 3) from a hub-layout
  state dict drawn by numpy, and the same weights in the HuggingFace
  ``Dinov2WithRegistersModel`` layout, through each package's loader: the
  CLS, register and patch features within 1e-4 of max|value|, the two
  layouts' port outputs equal, ``config_from_state_dict`` equal to JAX's.
  The JAX tree carried by ``params_from_jax`` gives the same output.
- ``pad_to_patch_multiple`` equals JAX's (the reference's ``create_pad``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diverse_channel_vit_tpu.models import dinov2 as jdino
from diverse_channel_vit_torch.models import dinov2
from diverse_channel_vit_torch.models.export import params_from_jax

DIM, HEADS, DEPTH, PATCH, REG, GRID = 64, 2, 2, 14, 4, 37


def hub_state(rng, dim=DIM, depth=DEPTH, patch=PATCH, reg=REG, grid=GRID) -> dict:
    """A hub-layout DINOv2 state dict drawn by numpy (``mask_token``, which
    the forward does not read, included)."""
    sd = {"cls_token": rng.normal(size=(1, 1, dim)),
          "pos_embed": 0.5 * rng.normal(size=(1, 1 + grid * grid, dim)),
          "register_tokens": rng.normal(size=(1, reg, dim)),
          "mask_token": rng.normal(size=(1, dim)),
          "patch_embed.proj.weight": rng.normal(size=(dim, 3, patch, patch)) / patch / 2,
          "patch_embed.proj.bias": 0.1 * rng.normal(size=dim),
          "norm.weight": 1 + 0.1 * rng.normal(size=dim), "norm.bias": 0.1 * rng.normal(size=dim)}
    for i in range(depth):
        o = f"blocks.{i}."
        for ln in ("norm1", "norm2"):
            sd[o + ln + ".weight"] = 1 + 0.1 * rng.normal(size=dim)
            sd[o + ln + ".bias"] = 0.1 * rng.normal(size=dim)
        for name, (n_out, n_in) in (("attn.qkv", (3 * dim, dim)), ("attn.proj", (dim, dim)),
                                    ("mlp.fc1", (4 * dim, dim)), ("mlp.fc2", (dim, 4 * dim))):
            sd[o + name + ".weight"] = rng.normal(size=(n_out, n_in)) / np.sqrt(n_in)
            sd[o + name + ".bias"] = 0.1 * rng.normal(size=n_out)
        sd[o + "ls1.gamma"] = 0.5 + 0.1 * rng.normal(size=dim)
        sd[o + "ls2.gamma"] = 0.5 + 0.1 * rng.normal(size=dim)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def hf_state(hub: dict) -> dict:
    """The same weights in HuggingFace ``Dinov2WithRegistersModel``'s names."""
    sd = {"embeddings.cls_token": hub["cls_token"],
          "embeddings.position_embeddings": hub["pos_embed"],
          "embeddings.register_tokens": hub["register_tokens"],
          "embeddings.mask_token": hub["mask_token"],
          "embeddings.patch_embeddings.projection.weight": hub["patch_embed.proj.weight"],
          "embeddings.patch_embeddings.projection.bias": hub["patch_embed.proj.bias"],
          "layernorm.weight": hub["norm.weight"], "layernorm.bias": hub["norm.bias"]}
    i = 0
    while f"blocks.{i}.norm1.weight" in hub:
        o, pre = f"blocks.{i}.", f"encoder.layer.{i}."
        for name in ("norm1", "norm2", "mlp.fc1", "mlp.fc2"):
            for leaf in ("weight", "bias"):
                sd[pre + f"{name}.{leaf}"] = hub[o + f"{name}.{leaf}"]
        for leaf in ("weight", "bias"):
            q, k, v = np.split(hub[o + f"attn.qkv.{leaf}"], 3)
            sd[pre + f"attention.attention.query.{leaf}"] = q
            sd[pre + f"attention.attention.key.{leaf}"] = k
            sd[pre + f"attention.attention.value.{leaf}"] = v
            sd[pre + f"attention.output.dense.{leaf}"] = hub[o + f"attn.proj.{leaf}"]
        sd[pre + "layer_scale1.lambda1"] = hub[o + "ls1.gamma"]
        sd[pre + "layer_scale2.lambda1"] = hub[o + "ls2.gamma"]
        i += 1
    return sd


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("side,out", [(37, 16), (37, 3), (16, 23), (10, 10)])
@pytest.mark.parametrize("offset,antialias", [(0.0, True), (0.1, False)])
def test_pos_embed_resample_matches_torch_interpolate(side, out, offset, antialias):
    rng = np.random.default_rng(side * 100 + out)
    pos = torch.from_numpy(rng.normal(size=(1, 1 + side * side, 8)).astype(np.float32))
    got = dinov2.interpolate_pos_embed_dinov2(pos, out, out, offset=offset, antialias=antialias)
    if out == side:  # the native grid: the hub returns the table as it is
        assert got is pos
        return
    grid = pos[:, 1:].reshape(1, side, side, 8).permute(0, 3, 1, 2)
    if offset:
        sf = (out + offset) / side
        want = F.interpolate(grid, scale_factor=(sf, sf), mode="bicubic", align_corners=False)
    else:
        want = F.interpolate(grid, size=(out, out), mode="bicubic", antialias=antialias,
                             align_corners=False)
    want = want.permute(0, 2, 3, 1).reshape(1, out * out, 8)
    assert torch.equal(got[:, :1], pos[:, :1])
    assert _rel(got[:, 1:].numpy(), want.numpy()) <= 1e-5
    jwant = jdino.interpolate_pos_embed_dinov2(jnp.asarray(pos.numpy()), out, out,
                                               offset=offset, antialias=antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0, atol=1e-6)


def test_aa_tables_match_jax():
    for size_in, size_out, sf in ((37, 16, 16 / 37), (37, 3, 3 / 37), (16, 23, 23 / 16)):
        idx, w = dinov2.torch_bicubic_1d_aa(size_in, size_out, sf)
        jidx, jw = jdino.torch_bicubic_1d_aa(size_in, size_out, sf)
        np.testing.assert_array_equal(idx, np.asarray(jidx))
        np.testing.assert_allclose(w, np.asarray(jw), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's forward of :func:`hub_state`'s weights on a 42 x 42 batch."""
    hub = hub_state(np.random.default_rng(0))
    cfg = jdino.config_from_state_dict(hub, num_heads=HEADS)
    jm = jdino.DinoV2ViT(**cfg)
    x = np.random.default_rng(1).normal(size=(3, 3, 42, 42)).astype(np.float32)
    shapes = jax.eval_shape(lambda xx: jm.init(jax.random.key(0), xx),
                            jax.ShapeDtypeStruct(x.shape, jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    params = jdino.load_torch_dinov2_state(zeros, hub)
    out = jax.jit(lambda p, xx: jm.apply({"params": p}, xx))(params, jnp.asarray(x))
    return dict(hub=hub, cfg=cfg, x=x, params=params,
                out={k: np.asarray(v) for k, v in out.items()})


def _port_forward(model, x):
    with torch.no_grad():
        return {k: v.numpy() for k, v in model.forward_features(torch.from_numpy(x)).items()}


@pytest.mark.parametrize("layout", ["hub", "hf"])
def test_forward_matches_jax_on_both_layouts(jax_reference, layout):
    r = jax_reference
    sd = r["hub"] if layout == "hub" else hf_state(r["hub"])
    cfg = dinov2.config_from_state_dict(sd, num_heads=HEADS)
    assert cfg == r["cfg"] == jdino.config_from_state_dict(sd, num_heads=HEADS)
    assert cfg["num_registers"] == REG and cfg["pos_grid"] == GRID and cfg["depth"] == DEPTH
    model = dinov2.load_torch_dinov2_state(dinov2.DinoV2ViT(**cfg),
                                           {k: torch.from_numpy(v) for k, v in sd.items()})
    got = _port_forward(model, r["x"])
    assert set(got) == set(r["out"])
    for key, want in r["out"].items():
        assert got[key].shape == want.shape, key
        assert _rel(got[key], want) <= 1e-4, key
    with torch.no_grad():
        cls = model(torch.from_numpy(r["x"])).numpy()
    np.testing.assert_array_equal(cls, got["x_norm_clstoken"])


def test_carried_jax_tree_gives_the_same_output(jax_reference):
    r = jax_reference
    model = dinov2.DinoV2ViT(**r["cfg"])
    model.load_state_dict(params_from_jax(jax.device_get(r["params"]), prefix=""), strict=True)
    got = _port_forward(model, r["x"])
    assert _rel(got["x_norm_clstoken"], r["out"]["x_norm_clstoken"]) <= 1e-4


def test_heads_and_layout_errors():
    hub = hub_state(np.random.default_rng(2), dim=48, depth=1)
    with pytest.raises(ValueError, match="num_heads"):
        dinov2.config_from_state_dict({**hub, "cls_token": np.zeros((1, 1, 50), np.float32)})
    model = dinov2.DinoV2ViT(**dinov2.config_from_state_dict(hub, num_heads=4))
    with pytest.raises(KeyError):
        dinov2.load_torch_dinov2_state(model, {k: v for k, v in hub.items()
                                               if k != "norm.bias"})
    with pytest.raises(ValueError, match="patch"):
        model(torch.zeros(1, 3, 20, 28))


@pytest.mark.parametrize("h,w", [(28, 28), (30, 33), (13, 42)])
def test_pad_to_patch_multiple_matches_jax(h, w):
    x = np.random.default_rng(h + w).normal(size=(2, 3, h, w)).astype(np.float32)
    got = dinov2.pad_to_patch_multiple(torch.from_numpy(x), PATCH).numpy()
    np.testing.assert_array_equal(got, jdino.pad_to_patch_multiple(x, PATCH))
