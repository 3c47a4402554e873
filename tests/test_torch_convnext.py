"""The ConvNeXt family in the port (``diverse_channel_vit_torch/models/
convnext.py``, ``convnext_variants.py``) against the JAX package's, on the
CPU.

Each of the six factories is built by both packages' ``build_model`` from a
config composed with ``model=<yaml>`` (the yaml defaults included:
``separate_coef: true``, ``hidden_dim: 128``, ``kernels_per_channel: 16``,
``weighted_sum_random``), on CHAMMI's 8-channel mapper (one chunk each; the
JAX model pinned to it with ``bind_chunk``, the port given ``chunk=``) and on
the single-chunk mapper of ``synthetic_cfg`` (chunk unset: the mapper's
first key in both), at 32², B = 2, f32. The JAX trunk runs at depths (1, 1,
1, 1) with dims 96-768 (``convnext_variants.TINY`` set for the module, as
``pooled_dim`` assumes 768), the port's too. The JAX parameter tree (shapes
from ``jax.eval_shape`` of its init, values drawn by numpy, LayerNorm scales
around 1) goes to the port through ``models.export.params_from_jax`` and
loads with ``strict=True``. JAX gives the output and the gradient of
``sum(out * r)`` for a fixed random r (no DropPath, so the train-mode
function), in three parts joined by the chain rule (:func:`_run`): the
stem with the trunk's stem LayerNorm (its forward and backward one jitted
function), the trunk's stages and pooling (compiled once for every case,
on one trunk tree every case shares), the head. The port runs its model
whole, eval forward and train-mode backward. Every other
``pooling_channel_type`` of DepthwiseConvNeXt runs the same way in
tests/test_torch_convnext_pooling.py.

Tolerances (the same f32 arithmetic in other summation orders): outputs
within 1e-4 of max|out|; each parameter's gradient within 1e-4 of its own
max|g|, absolute 1e-6 where a gradient is all but zero.

Also against JAX: ``initialize_first_conv_layer`` in every mode (the raises
included), ``pad_dups_param_bank``, ``apply_pretrained_convnext`` from a
timm-layout state dict this test writes (the trunk at Tiny depth, so most of
its blocks are keys the cut trunk lacks and skips, as JAX does; a head key
and a mismatched shape skipped too), within 1e-7; the freeze labels of each
model against JAX's ``build_trainable_labels``, leaf for leaf, through the
carrier; the Trainer's novel-channel override of each model's table
against JAX's ``synthesize_rows``; ``adaptive_pool_4x4`` against the JAX
bins at a size 4 does not divide; DropPath's masks.
"""

import copy
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diverse_channel_vit_tpu.models.convnext_variants as jcv
from diverse_channel_vit_tpu.config import load_config as jload_config
from diverse_channel_vit_tpu.models import build_model as jbuild_model
from diverse_channel_vit_tpu.models import convnext as jconvnext
from diverse_channel_vit_tpu.models.wrappers import bind_chunk
from diverse_channel_vit_tpu.training import freeze as jfreeze
import diverse_channel_vit_torch.models.convnext_variants as cv
from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.models import build_model
from diverse_channel_vit_torch.models import convnext
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.training.freeze import build_trainable_labels

CUT = dict(depths=(1, 1, 1, 1), dims=(96, 192, 384, 768))
CHAMMI = {"Allen": [5, 2, 6], "HPA": [3, 6, 5, 0], "CP": [5, 0, 7, 1, 4]}
SINGLE = {"train": list(range(8)), "valid": list(range(8)), "test": list(range(8))}
NC = 6
OUT_REL, GRAD_REL = 1e-4, 1e-4
YAMLS = {"convnext_base": "convnext_base", "shared_convnext": "shared_convnext",
         "sliceparamconvnext": "sliceparam", "templatemixingconvnext": "template_mixing_conv",
         "hyperconvnext": "hyperconvnext", "depthwiseconvnext": "depthwiseconvnext"}
# (model, mapper, chunk, extra overrides, channel ids of the batch)
FACTORY_CASES = {
    "base-chammi": ("convnext_base", "chammi", "Allen", [], None),
    "shared-chammi": ("shared_convnext", "chammi", "HPA", [], None),
    "sliceparam-chammi": ("sliceparamconvnext", "chammi", "CP", ["++model.slice_class_emb=True"],
                          None),
    "templatemixing-chammi": ("templatemixingconvnext", "chammi", "Allen", [], None),
    "hyper-chammi": ("hyperconvnext", "chammi", "HPA", [], None),
    "depthwise-chammi": ("depthwiseconvnext", "chammi", "CP", ["++model.patch_size=4"], None),
    "base-single": ("convnext_base", "single", None, [], None),
    "shared-single": ("shared_convnext", "single", None, ["++model.pooling=avg_max"], None),
    "sliceparam-single": ("sliceparamconvnext", "single", None, ["++model.duplicate=True"],
                          [0, 2, 3, 5, 6]),
    "templatemixing-single": ("templatemixingconvnext", "single", None,
                              ["++model.separate_coef=False", "++model.num_templates=16"],
                              [0, 2, 3, 5, 6]),
    "hyper-single": ("hyperconvnext", "single", None, ["++model.separate_emb=True"], None),
    "depthwise-single": ("depthwiseconvnext", "single", None,
                         ["++model.patch_size=4", "++model.pooling_channel_type=avg"],
                         [1, 2, 4, 7]),
}
@pytest.fixture(autouse=True, scope="module")
def _cut_trunk_two_threads():
    """The cut trunk in both packages; XLA's optimisation passes off while
    the JAX references compile (they cost the compile, not the numbers, a
    few f32 ulps); torch on two threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    opt = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jcv, "TINY", CUT)
            mp.setattr(cv, "TINY", CUT)
            yield
    finally:
        jax.config.update("jax_disable_most_optimizations", opt)
        torch.set_num_threads(threads)


def _fill(shapes, seed: int):
    """A param tree of these shapes drawn by numpy: LayerNorm scales 1 +
    0.1 N(0, 1), biases 0.05 N(0, 1), layer scales 0.5 + 0.1 N(0, 1) (so the
    blocks count), every other leaf N(0, 1) at min(0.5, fan^-1/2), fan the
    product of all but the last axis."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        z = rng.standard_normal(s.shape, dtype=np.float32)
        if name == "scale":
            return 1.0 + 0.1 * z
        if name == "gamma":
            return 0.5 + 0.1 * z
        fan = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        std = 0.05 if "bias" in name or name in ("b", "b_out") else min(0.5, fan ** -0.5)
        return np.float32(std) * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _configs(name, extra):
    base = "chammi_cfg" if extra[0] == "chammi" else "synthetic_cfg"
    over = [f"model={YAMLS[name]}", "train.dtype=float32", *extra[1]]
    jcfg, cfg = jload_config(base, over), load_config(base, over)
    for c in (jcfg, cfg):
        c.model.in_channel_names = c.dataset.in_channel_names
    return jcfg, cfg


# the stem's output at 32^2 (NHWC): every model's stem takes the image to
# 8 x 8 x 96 (a 4 x 4 stride, or DepthwiseConvNeXt's patch_size 4)
STEM_OUT = (2, 8, 8, 96)


@functools.lru_cache(maxsize=None)
def _jax_stages():
    """JAX's ``ConvNeXtTrunk`` at the cut depth without its stem norm, then
    ``feature_pool(..., "avg_max")``, as one jitted function of (stem
    output NHWC, cotangent of the pooled features): the features and the
    gradients of the trunk's params and of the stem output; and the trunk's
    tree, drawn once by :func:`_fill` and shared by every case. ``avg`` is
    the first half of ``avg_max``, with a zero cotangent on the second.
    Compiled once, with XLA's optimisations on: it runs in every case."""
    trunk = jconvnext.ConvNeXtTrunk(include_stem_norm=False, **CUT)
    shapes = jax.eval_shape(lambda: trunk.init(jax.random.key(0), jnp.zeros(STEM_OUT),
                                               train=False))
    tp = jax.device_put(_fill(shapes["params"], seed=2))

    def fwd(tp, y):
        out = trunk.apply({"params": tp}, y, train=False)
        return jconvnext.feature_pool(out, "avg_max").astype(jnp.float32)

    def fwd_bwd(y, g):
        feat, vjp = jax.vjp(fwd, tp, y)
        return (feat,) + vjp(g)

    jax.config.update("jax_disable_most_optimizations", False)
    try:
        fn = jax.jit(fwd_bwd).lower(
            jax.ShapeDtypeStruct(STEM_OUT, jnp.float32),
            jax.ShapeDtypeStruct((2, jconvnext.pooled_dim("avg_max")), jnp.float32)).compile()
    finally:
        jax.config.update("jax_disable_most_optimizations", True)
    return fn, tp


class _StemNorm(flax.linen.Module):
    """Stands in for the trunk in the stem's function: the trunk's stem
    LayerNorm alone (``ConvNeXtTrunk``'s first op, under its name)."""

    include_stem_norm: bool

    @flax.linen.compact
    def __call__(self, y):
        if self.include_stem_norm:
            y = flax.linen.LayerNorm(epsilon=1e-6, dtype=jnp.float32, name="stem_norm")(y)
        return y


@functools.lru_cache(maxsize=None)
def _run(name, mapper_kind, chunk, extra, ids):
    """Both packages' models from one JAX tree, and JAX's output and
    gradient of sum(out * r). JAX's model runs as its backbone with the
    trunk's stages cut out (``_ConvNeXtCore.trunk`` made the trunk's stem
    norm alone, :class:`_StemNorm`: the stem's NHWC output; its tree built
    with a stand-in of the pooled features' shape, and given the shared
    stages' tree), then :func:`_jax_stages`, then the wrapper's head (a
    Dense, off CHAMMI), the chain rule joining them: the stages compile
    once for every case, the stem's forward and backward in one compile."""
    mapper = CHAMMI if mapper_kind == "chammi" else SINGLE
    jcfg, cfg = _configs(name, (mapper_kind, list(extra)))
    jm = jbuild_model(name, jcfg.model, mapper, NC, dtype=jnp.float32)
    if chunk is not None:
        jm = bind_chunk(jm, chunk)
    ids = list(ids) if ids is not None else mapper[chunk or "train"]
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=(2, len(ids), 32, 32)).astype(np.float32))
    jids = jnp.asarray(ids)
    pooling = cfg.model.get("pooling") or "avg"
    assert pooling in ("avg", "avg_max"), pooling
    stages_fn, stages_params = _jax_stages()

    def init_trunk(self, y, *, train):
        _StemNorm(self.include_stem_norm, name="trunk")(y)
        return jnp.zeros((y.shape[0], jconvnext.pooled_dim(self.pooling)), jnp.float32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcv._ConvNeXtCore, "trunk", init_trunk)
        shapes = jax.eval_shape(lambda xx: jm.init({"params": jax.random.key(0)}, xx, jids,
                                                   train=False),
                                jax.ShapeDtypeStruct(x.shape, jnp.float32))
    params = _fill(shapes["params"], seed=1)
    stem_params = params["backbone"]
    head = params.get("classifier_head")
    r = rng.normal(size=(2, NC if head is not None else convnext.pooled_dim(pooling)))
    r = jnp.asarray(r.astype(np.float32))

    def stem(bp):
        return jm.backbone.apply({"params": bp}, x, jids, train=False)[0]

    def stem_vjp(bp, g):
        y, vjp = jax.vjp(stem, bp)
        return y, vjp(g)[0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcv._ConvNeXtCore, "trunk", lambda self, y, *, train: _StemNorm(
            self.include_stem_norm, name="trunk")(y))
        stem_fn = jax.jit(stem_vjp)
        y, _ = stem_fn(stem_params, jnp.zeros(STEM_OUT, jnp.float32))
        g_feat = r if head is None else r @ head["kernel"].T
        if pooling == "avg":
            g_feat = jnp.concatenate([g_feat, jnp.zeros_like(g_feat)], axis=-1)
        feat, g_stages, g_y = stages_fn(y, g_feat)
        g_bb = dict(stem_fn(stem_params, g_y)[1])
    if pooling == "avg":
        feat = feat[:, :convnext.pooled_dim("avg")]
    params["backbone"] = {**stem_params,
                          "trunk": {**stem_params.get("trunk", {}), **stages_params}}
    g_bb["trunk"] = {**g_bb.get("trunk", {}), **g_stages}
    grads = {"backbone": g_bb, "proxies": jnp.zeros_like(params["proxies"])}
    out = feat
    if head is not None:
        out = feat @ head["kernel"] + head["bias"]
        grads["classifier_head"] = {"kernel": feat.T @ r, "bias": r.sum(axis=0)}
    model = build_model(name, cfg.model, mapper, NC, device="cpu")
    model.load_state_dict(params_from_jax(params), strict=True)
    return dict(model=model, params=params, x=np.asarray(x), ids=ids, r=np.asarray(r),
                chunk=chunk, out=np.asarray(out), grads=params_from_jax(grads))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _check(r):
    model, x, ids = r["model"], torch.from_numpy(r["x"]), torch.tensor(r["ids"])
    kw = {} if r["chunk"] is None else {"chunk": r["chunk"]}
    model.eval()
    with torch.no_grad():
        got, extra = model(x, ids, **kw)
    assert got.shape == r["out"].shape and got.dtype == torch.float32 and float(extra) == 0.0
    assert _rel(got.numpy(), r["out"]) <= OUT_REL
    model.train()
    model.zero_grad(set_to_none=True)
    try:
        (model(x, ids, **kw)[0] * torch.from_numpy(r["r"])).sum().backward()
    finally:
        model.eval()
    for pname, p in model.named_parameters():
        want = r["grads"][pname]
        got = torch.zeros_like(want) if p.grad is None else p.grad
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= max(GRAD_REL * scale, 1e-6), pname


@pytest.mark.parametrize("case", sorted(FACTORY_CASES))
def test_factory_output_and_gradient_match_jax(case):
    name, mapper_kind, chunk, extra, ids = FACTORY_CASES[case]
    _check(_run(name, mapper_kind, chunk, tuple(extra), None if ids is None else tuple(ids)))


def test_convnext_base_at_the_tiny_depth_matches_jax(monkeypatch):
    """The one case at the real ConvNeXt-Tiny depth (3, 3, 9, 3): the
    factory's eval output on CHAMMI's Allen chunk, JAX's model jitted whole,
    within 1e-4 of max|out|."""
    monkeypatch.setattr(jcv, "TINY", convnext.TINY)
    monkeypatch.setattr(cv, "TINY", convnext.TINY)
    jcfg, cfg = _configs("convnext_base", ("chammi", []))
    jm = bind_chunk(jbuild_model("convnext_base", jcfg.model, CHAMMI, NC, dtype=jnp.float32),
                    "Allen")
    x = np.random.default_rng(4).normal(size=(2, 3, 32, 32)).astype(np.float32)
    ids = jnp.asarray(CHAMMI["Allen"])
    shapes = jax.eval_shape(lambda xx: jm.init({"params": jax.random.key(0)}, xx, ids,
                                               train=False),
                            jax.ShapeDtypeStruct(x.shape, jnp.float32))
    params = _fill(shapes["params"], seed=6)
    want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x), ids,
                                                  train=False)[0])(params))
    model = build_model("convnext_base", cfg.model, CHAMMI, NC, device="cpu")
    assert sum(len(s.blocks) for s in model.feature_extractor.trunk.stages) == 18
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.tensor(CHAMMI["Allen"]), chunk="Allen")[0]
    assert _rel(got.numpy(), want) <= OUT_REL


def test_drop_path_masks_drop_whole_blocks():
    """DropPath (``drop_path_rate``, rising to it at the last block): in
    training, a block whose (B,) mask is False for a sample adds nothing to
    that sample, one whose mask holds adds its branch over 1 - rate (JAX's
    ``ConvNeXtBlock``): all masks False give the output of the same model
    with every layer scale 0; all True, that of the model with each layer
    scale divided by its block's keep rate. The step's generator draws one
    mask per block."""
    jcfg, cfg = _configs("convnext_base", ("single", ["++model.drop_path_rate=0.5"]))
    model = build_model("convnext_base", cfg.model, SINGLE, NC, device="cpu")
    fe = model.feature_extractor
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 8, 32, 32)).astype(np.float32))
    ids = torch.arange(8)
    with torch.no_grad():
        for blk in fe.trunk.blocks:
            blk.gamma.fill_(0.5)
        masks = fe.draw_drop_path(2, torch.Generator().manual_seed(0))
        assert [m is None for m in masks] == [True] + [False] * 3
        model.train()
        off = model(x, ids, drop_path=[None if m is None else torch.zeros_like(m)
                                       for m in masks])[0]
        on = model(x, ids, drop_path=[None if m is None else torch.ones_like(m)
                                      for m in masks])[0]
        model.eval()
        for blk in fe.trunk.blocks[1:]:
            blk.gamma.zero_()
        np.testing.assert_allclose(off.numpy(), model(x, ids)[0].numpy(), rtol=0, atol=1e-6)
        for blk in fe.trunk.blocks:
            blk.gamma.fill_(0.5 / (1.0 - blk.drop_path))
        np.testing.assert_allclose(on.numpy(), model(x, ids)[0].numpy(), rtol=1e-5, atol=1e-6)


def test_chunk_changes_the_stem_not_the_parameters():
    """A chunk-aware model holds every chunk's stem: the same parameters
    serve every chunk (JAX ``test_chunk_clones_share_param_tree``), and the
    chunk picks which one a forward uses."""
    r = _run("shared_convnext", "chammi", "HPA", (), None)
    model = r["model"]
    names = {n for n, _ in model.named_parameters()}
    assert {f"feature_extractor.stem_conv_{c}" for c in CHAMMI} <= names
    x = torch.from_numpy(r["x"])
    with torch.no_grad():
        a = model(x, torch.tensor(CHAMMI["HPA"]), chunk="HPA")[0]
        with pytest.raises(RuntimeError):  # CP's stem takes 5 channels
            model(x, torch.tensor(CHAMMI["HPA"]), chunk="CP")
    assert torch.equal(a, model(x, torch.tensor(CHAMMI["HPA"]), chunk="HPA")[0].detach())


def test_adaptive_pool_bins_match_jax():
    y = np.random.default_rng(5).normal(size=(2, 3, 7, 10)).astype(np.float32)
    for reduce, jfn in (("mean", jnp.mean), ("amax", jnp.max)):
        want = np.asarray(jcv._adaptive_pool_4x4(jnp.asarray(y), jfn))
        got = cv.adaptive_pool_4x4(torch.from_numpy(y), reduce).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _hwio(t):
    return np.asarray(t).transpose(2, 3, 1, 0)


@pytest.mark.parametrize("in_dim", [3, 4, 5, 6, 8])
def test_initialize_first_conv_layer_matches_jax(in_dim):
    """Every mode against JAX; past 6 channels from 3, ``pretrained_pad_avg``
    averages an empty window: JAX fills the channel with NaN (as the
    reference), the port raises ``ValueError``."""
    rng = np.random.default_rng(in_dim)
    stem = rng.normal(size=(96, in_dim, 4, 4)).astype(np.float32)
    pre = rng.normal(size=(96, 3, 4, 4)).astype(np.float32)
    modes = ["reinit_as_random", "pretrained_pad_random", None]
    if in_dim <= 6:
        modes.append("pretrained_pad_avg")
    else:
        with np.errstate(invalid="ignore"), pytest.warns(RuntimeWarning):
            jnan = np.asarray(jconvnext.initialize_first_conv_layer(
                jnp.asarray(_hwio(stem)), pre, "pretrained_pad_avg"))
        assert np.isnan(jnan[:, :, 6:]).all() and np.isfinite(jnan[:, :, :6]).all()
        with pytest.raises(ValueError, match="pretrained_pad_random"):
            convnext.initialize_first_conv_layer(torch.from_numpy(stem), pre,
                                                 "pretrained_pad_avg")
    for mode in modes:
        want = np.asarray(jconvnext.initialize_first_conv_layer(jnp.asarray(_hwio(stem)), pre,
                                                                mode))
        got = convnext.initialize_first_conv_layer(torch.from_numpy(stem), pre, mode)
        np.testing.assert_allclose(_hwio(got.numpy()), want, rtol=0, atol=1e-7, err_msg=mode)
    for mode in ("pretrained_pad_dups", "no_such_mode"):
        for fn in (lambda: jconvnext.initialize_first_conv_layer(jnp.asarray(_hwio(stem)), pre,
                                                                 mode),
                   lambda: convnext.initialize_first_conv_layer(torch.from_numpy(stem), pre,
                                                                mode)):
            with pytest.raises(NotImplementedError):
                fn()
    wide = rng.normal(size=(96, in_dim + 1, 4, 4)).astype(np.float32)
    with pytest.raises(ValueError):
        convnext.initialize_first_conv_layer(torch.from_numpy(stem), wide, "pretrained_pad_avg")
    bank = rng.normal(size=(96, in_dim, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        convnext.pad_dups_param_bank(torch.from_numpy(bank), pre).numpy(),
        np.asarray(jconvnext.pad_dups_param_bank(jnp.asarray(bank), pre)))


def _timm_state(rng):
    """A timm ``convnext_tiny`` state dict at the real Tiny depth, the stem
    at 3 channels, plus the classifier head timm carries, drawn in f32."""
    def n(*size):
        return rng.standard_normal(size, dtype=np.float32)

    sd = {"stem.0.weight": n(96, 3, 4, 4), "stem.0.bias": n(96),
          "stem.1.weight": 1 + 0.1 * n(96), "stem.1.bias": n(96),
          "head.fc.weight": n(1000, 768), "head.fc.bias": n(1000)}
    dims = convnext.TINY["dims"]
    for s, (depth, dim) in enumerate(zip(convnext.TINY["depths"], dims)):
        if s:
            sd[f"stages.{s}.downsample.0.weight"] = n(dims[s - 1])
            sd[f"stages.{s}.downsample.0.bias"] = n(dims[s - 1])
            sd[f"stages.{s}.downsample.1.weight"] = n(dim, dims[s - 1], 2, 2)
            sd[f"stages.{s}.downsample.1.bias"] = n(dim)
        for b in range(depth):
            p = f"stages.{s}.blocks.{b}."
            sd[p + "conv_dw.weight"] = n(dim, 1, 7, 7)
            sd[p + "conv_dw.bias"] = n(dim)
            sd[p + "norm.weight"] = n(dim)
            sd[p + "norm.bias"] = n(dim)
            sd[p + "mlp.fc1.weight"] = n(4 * dim, dim)
            sd[p + "mlp.fc1.bias"] = n(4 * dim)
            sd[p + "mlp.fc2.weight"] = n(dim, 4 * dim)
            sd[p + "mlp.fc2.bias"] = n(dim)
            sd[p + "gamma"] = n(dim)
    sd["stages.0.blocks.0.gamma"] = n(95)  # a shape no trunk has: skipped
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}


@pytest.mark.parametrize("case,mode", [("base-chammi", "pretrained_pad_avg"),
                                       ("shared-chammi", "pretrained_pad_random"),
                                       ("sliceparam-chammi", "pretrained_pad_dups"),
                                       ("hyper-chammi", "pretrained_pad_avg")])
def test_apply_pretrained_convnext_matches_jax(case, mode):
    name, mapper_kind, chunk, extra, ids = FACTORY_CASES[case]
    r = _run(name, mapper_kind, chunk, tuple(extra), None if ids is None else tuple(ids))
    sd = _timm_state(np.random.default_rng(9))
    want = params_from_jax(jconvnext.apply_pretrained_convnext(
        dict(r["params"]), {k: v.numpy() for k, v in sd.items()}, name, init_first_layer=mode,
        mapper=CHAMMI))
    model = copy.deepcopy(r["model"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = convnext.apply_pretrained_convnext(model, sd, name, init_first_layer=mode,
                                                mapper=CHAMMI)
    assert "trunk.stages.0.blocks.0.conv_dw.weight" in loaded
    assert "trunk.stages.0.blocks.0.gamma" not in loaded
    changed = set()
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-7, err_msg=k)
        if not torch.equal(v, before[k]):
            changed.add(k)
    stems = {"convnext_base": {"feature_extractor.stem_conv"},
             "shared_convnext": {f"feature_extractor.stem_conv_{c}" for c in CHAMMI},
             "sliceparamconvnext": {"feature_extractor.conv1_param_bank"},
             "hyperconvnext": set()}[name]
    assert stems <= changed and "feature_extractor.trunk.stages.0.blocks.0.gamma" not in changed


@pytest.mark.parametrize("case,table", [("hyper-chammi", "conv1_emb"),
                                        ("templatemixing-single", "conv1_coefs"),
                                        ("depthwise-chammi", "conv1depthwise_param_bank")])
def test_override_tables_match_jax(case, table):
    """The port Trainer's ``_synthesis_override`` of each ConvNeXt model's
    table (DepthwiseConvNeXt's bank as (C_total, k, 3, 3), JAX
    ``trainer.py:1244-1246``) for a test split holding two channels
    training lacks equals JAX's ``synthesize_rows`` of the JAX tree's table
    under ``avg_2``, ``replicate`` and ``zero``, within 1e-7; the
    override then goes through the forward as the table's rows."""
    from diverse_channel_vit_tpu.ops import novel_channels as jnc
    from diverse_channel_vit_torch.trainer import Trainer

    name, mapper_kind, chunk, extra, ids = FACTORY_CASES[case]
    r = _run(name, mapper_kind, chunk, tuple(extra), None if ids is None else tuple(ids))
    t = Trainer.__new__(Trainer)
    t.cfg, t.model = _configs(name, (mapper_kind, list(extra)))[1], r["model"]
    t.mapper = {"train": [0, 1, 2, 3, 4, 5], "test": [0, 6, 2, 7, 5]}
    jtable = np.asarray(r["params"]["backbone"][table])
    if name == "depthwiseconvnext":
        jtable = jtable.reshape(8, -1, 3, 3)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(2, 5, 32, 32)).astype(np.float32))
    for strategy in ("avg_2", "replicate", "zero"):
        t.host_rng = np.random.default_rng(5)
        got = t._synthesis_override("test", strategy)
        plan = jnc.synthesis_plan(t.mapper, "test", "train", strategy,
                                  rng=np.random.default_rng(5))
        want = np.asarray(jnc.synthesize_rows(jnp.asarray(jtable), plan))
        assert got.shape == want.shape == (5,) + jtable.shape[1:], strategy
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7, err_msg=strategy)
    with torch.no_grad():
        kw = {} if r["chunk"] is None else {"chunk": r["chunk"]}
        out = r["model"](x, torch.tensor([0, 6, 2, 7, 5]), got, **kw)[0]
    assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("case", sorted(k for k in FACTORY_CASES if k.endswith("chammi")))
def test_freeze_labels_match_jax(case):
    name, mapper_kind, chunk, extra, ids = FACTORY_CASES[case]
    r = _run(name, mapper_kind, chunk, tuple(extra), None if ids is None else tuple(ids))
    tree = dict(r["params"])
    jlabels = jfreeze.build_trainable_labels(tree, freeze_other=True)
    as_numbers = jax.tree_util.tree_map(
        lambda lab, p: np.full(np.shape(p), 1.0 if lab == "train" else 0.0, np.float32),
        jlabels, tree)
    want = params_from_jax(as_numbers)
    got = build_trainable_labels(r["model"].named_parameters(), freeze_other=True)
    assert set(got) == set(want) - {"adaptive_interface.0"}
    for pname, lab in got.items():
        assert set(np.unique(want[pname].numpy()).tolist()) == {1.0 if lab == "train" else 0.0}
    assert {"train", "freeze"} == set(got.values())
    # JAX's block regex finds no ConvNeXt block: both refuse last-n freezing
    with pytest.raises(ValueError):
        jfreeze.build_trainable_labels(tree, unfreeze_last_n_layers=1)
    with pytest.raises(ValueError):
        build_trainable_labels(r["model"].named_parameters(), unfreeze_last_n_layers=1)
