"""The paper's baseline ViTs in the port (``diverse_channel_vit_torch/models/``:
``vit_adapt``, ``depthwisevit_adapt`` with both channel poolings,
``hypervit_adapt``, ``templatemixingvit``) against the JAX package's, on the
CPU.

Each variant is built by both packages' ``build_model`` from
``synthetic_cfg`` as composed with ``model=<name>`` (the yaml defaults
included: ``hidden_dim: 128``, ``num_templates: 10``, the ``param1``
attention pooling), cut to depth 2, D = 128 in 2 heads of 64, 32^2 with
patch 8, f32. The JAX parameter tree (shapes from ``jax.eval_shape`` of its
init, values drawn by numpy from a seed, LayerNorm scales around 1 and
biases off 0) goes to the port through ``models.export.params_from_jax``
and loads with ``strict=True``. One jitted JAX function per variant gives
the eval forward on 5 of the 8 channels and the gradients of one train
step (JAX ``make_grad_step``, cross entropy over the head); the port runs
its eval forward and its ``make_train_step`` (AdamW) on the same inputs.

Tolerances (the same f32 arithmetic in other summation orders, as
tests/test_torch_model.py holds ChannelViT): logits within 1e-4 of
max|logit|; the step's loss and gradient norm within rtol 1e-5; each
parameter's gradient within 1e-4 of its max|g| (the JAX gradients carried
through the same carrier).

Also held against JAX: the four hypernetwork classes of ``models/hypernet.py``
(rel 1e-5), the channel attention pooling with its CLS token and its
channel tokens (rel 1e-5), the Trainer's novel-channel override of each
model's own table (``conv1_emb``, ``conv1_coefs``, ``channel_embed``) under
every static strategy against JAX's ``synthesize_rows`` on the same table
(within 1e-7 absolute), and the freeze labels of each model against JAX's
``build_trainable_labels``, label for label. The samplers that read a table
a model lacks raise ``ValueError`` naming it; ``uniform`` trains every model.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diverse_channel_vit_tpu.config import load_config as jload_config
from diverse_channel_vit_tpu.models import build_model as jbuild_model
from diverse_channel_vit_tpu.models import channel_attention_pooling as jcap
from diverse_channel_vit_tpu.models import hypernet as jhyper
from diverse_channel_vit_tpu.ops import novel_channels as jnc
from diverse_channel_vit_tpu.training import freeze as jfreeze
from diverse_channel_vit_tpu.training.steps import make_grad_step as jmake_grad_step
from diverse_channel_vit_torch.config import load_config
from diverse_channel_vit_torch.models import build_model
from diverse_channel_vit_torch.models import channel_attention_pooling as cap
from diverse_channel_vit_torch.models import hypernet
from diverse_channel_vit_torch.models.export import params_from_jax
from diverse_channel_vit_torch.ops.novel_channels import STATIC_STRATEGIES
from diverse_channel_vit_torch.trainer import Trainer
from diverse_channel_vit_torch.training import (TrainState, make_lr_schedule, make_optimizer,
                                                make_train_step)
from diverse_channel_vit_torch.training.freeze import build_trainable_labels

SMALL = ["++model.embed_dim=128", "++model.depth=2", "++model.num_heads=2",
         "++model.img_size=[32]", "++model.patch_size=8", "train.dtype=float32"]
VARIANTS = {
    "vit_adapt": ["model=vit_adapt"],
    "depthwise_weights": ["model=depthwisevit_adapt"],
    "depthwise_attention": ["model=depthwisevit_adapt", "++model.pooling_channel_type=attention",
                            "attn_pooling=param1"],
    "hypervit": ["model=hypervit_adapt"],
    "templatemixing": ["model=templatemixingvit"],
}
MAPPER = {"train": list(range(8)), "valid": list(range(8)), "test": list(range(8))}
IDS = [0, 2, 3, 5, 6]
NC = 10
LOGITS_REL, GRAD_REL, LOSS_RTOL = 1e-4, 1e-4, 1e-5
# each model's novel-channel table in the JAX tree (JAX trainer.py:1219-1229)
JAX_TABLES = {"depthwise_weights": "channel_embed", "hypervit": "conv1_emb",
              "templatemixing": "conv1_coefs"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _fill(shapes, seed: int):
    """A param tree of these shapes drawn by numpy: LayerNorm scales 1 +
    0.1 N(0, 1), biases 0.05 N(0, 1), every other leaf N(0, 1) at
    min(0.5, fan^-1/2) with fan the product of all but the last axis."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        std = 0.05 if name in ("bias", "b", "b_out", "proj_bias") else min(0.5, fan ** -0.5)
        return (std * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _configs(variant):
    over = SMALL + VARIANTS[variant]
    jcfg, cfg = jload_config("synthetic_cfg", over), load_config("synthetic_cfg", over)
    for c in (jcfg, cfg):
        c.model.in_channel_names = c.dataset.in_channel_names
    return jcfg, cfg


def _as_dict(section):
    return section.to_dict() if hasattr(section, "to_dict") else section


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, len(IDS), 32, 32)).astype(np.float32)
    return x, rng.integers(0, NC, size=4)


@functools.lru_cache(maxsize=None)
def _run(variant):
    """Both packages' models of ``variant`` from one JAX param tree, and
    JAX's eval logits, step gradients and loss on :func:`_inputs`."""
    jcfg, cfg = _configs(variant)
    jm = jbuild_model(jcfg.model.name, jcfg.model, MAPPER, NC, dtype=jnp.float32,
                      attn_pooling=_as_dict(jcfg.get("attn_pooling")))
    x, y = _inputs()
    ids = jnp.asarray(IDS)
    shapes = jax.eval_shape(lambda xx: jm.init({"params": jax.random.key(0)}, xx, ids,
                                               train=False), jax.ShapeDtypeStruct(x.shape,
                                                                                  jnp.float32))
    params = _fill(shapes["params"], seed=1)
    grad_step = jmake_grad_step(jm, channel_ids=IDS, loss_type="ce")
    both = jax.jit(lambda p, xx, yy: (
        jm.apply({"params": p}, xx, ids, train=False)[0],
        grad_step(p, {"image": xx, "label": yy}, jax.random.key(1))))
    logits, (grads, metrics) = both(params, jnp.asarray(x), jnp.asarray(y))
    model = build_model(cfg.model.name, cfg.model, MAPPER, NC, device="cpu",
                        attn_pooling=_as_dict(cfg.get("attn_pooling")))
    model.load_state_dict(params_from_jax(params), strict=True)
    return dict(params=params, model=model, cfg=cfg, logits=np.asarray(logits),
                grads=params_from_jax(grads), loss=float(metrics["loss"]),
                grad_norm=float(optax.global_norm(grads)))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_f32_match_jax(variant):
    r = _run(variant)
    x, _ = _inputs()
    with torch.no_grad():
        got, extra = r["model"](torch.from_numpy(x), torch.tensor(IDS))
    assert got.shape == (4, NC) and got.dtype == torch.float32 and float(extra) == 0.0
    assert _rel(got.numpy(), r["logits"]) <= LOGITS_REL


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_matches_jax(variant):
    r = _run(variant)
    x, y = _inputs()
    model = r["model"]
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    lr = make_lr_schedule("none", 1e-3, {}, num_epochs=1, steps_per_epoch=1)
    state = TrainState(model, make_optimizer("adamw", {"lr": 1e-3, "weight_decay": 0.05},
                                             lr_schedule=lr, total_steps=1))
    step = make_train_step(model, channel_ids=IDS, loss_type="ce")
    try:
        _, m = step(state, {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})
        np.testing.assert_allclose(float(m["loss"]), r["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), r["grad_norm"], rtol=LOSS_RTOL)
        for name, p in model.named_parameters():
            want = r["grads"][name]
            got = torch.zeros_like(want) if p.grad is None else p.grad
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= GRAD_REL * max(scale, 1e-12), name
        moved = [n for n, p in model.named_parameters() if not torch.equal(p.detach(), sd[n])]
        assert moved, "the optimizer updated nothing"
    finally:
        model.load_state_dict(sd)
        model.eval()


def test_hypernet_classes_match_jax():
    rng = np.random.default_rng(4)
    z2 = rng.normal(size=(5, 16)).astype(np.float32)
    z3 = rng.normal(size=(3, 5, 16)).astype(np.float32)
    cases = [
        (jhyper.HyperNetwork(16, 32, 4, 24), hypernet.HyperNetwork(16, 32, 4, 24), z2),
        (jhyper.HyperNetwork(16, 32, 4, 24, in_size=2, use_conv1x1=True),
         hypernet.HyperNetwork(16, 32, 4, 24, in_size=2, use_conv1x1=True), z2),
        (jhyper.HyperNetworkV2(16, 32, 4, 24), hypernet.HyperNetworkV2(16, 32, 4, 24), z3),
        (jhyper.HyperNetworkV2(16, 32, 4, 24, use_conv1x1=True),
         hypernet.HyperNetworkV2(16, 32, 4, 24, use_conv1x1=True), z3),
        (jhyper.HyperNetworkChannelEmbV2(16, 32, 24), hypernet.HyperNetworkChannelEmbV2(16, 32, 24),
         z3),
        (jhyper.HyperNetworkChannelEmb(16, 32, 24, in_size=2),
         hypernet.HyperNetworkChannelEmb(16, 32, 24, in_size=2), z2),
    ]
    for i, (jmod, mod, z) in enumerate(cases):
        shapes = jax.eval_shape(lambda zz, m=jmod: m.init(jax.random.key(0), zz),
                                jax.ShapeDtypeStruct(z.shape, jnp.float32))
        params = _fill(shapes["params"], seed=10 + i)
        want = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(z)))
        assert sorted(params) == sorted(n for n, _ in mod.named_parameters()), i
        mod.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()},
                            strict=True)
        with torch.no_grad():
            got = mod(torch.from_numpy(z)).numpy()
        assert got.shape == want.shape, i
        assert _rel(got, want) <= 1e-5, i


def test_channel_attention_pooling_matches_jax():
    """With its CLS token and its channel tokens (drawn at random): depth 2,
    4 heads of 16, 8 of 12 channels, N = 6 patches, K = 64; the last channel
    position is read, as JAX (and the reference) read it. The
    ``depthwise_attention`` variant holds the pooling without either."""
    kw = dict(max_num_channels=12, dim=64, depth=2, heads=4, dim_head=16, mlp_dim=32,
              use_cls_token=True, use_channel_tokens=True, init_channel_tokens="random")
    jmod = jcap.ChannelAttentionPoolingLayer(**kw)
    mod = cap.ChannelAttentionPoolingLayer(**kw)
    rng = np.random.default_rng(6)
    tokens = rng.normal(size=(2, 8, 6, 64)).astype(np.float32)
    ids = jnp.asarray([0, 2, 3, 5, 7, 8, 10, 11])
    shapes = jax.eval_shape(lambda t: jmod.init(jax.random.key(0), t, ids, train=False),
                            jax.ShapeDtypeStruct(tokens.shape, jnp.float32))
    params = _fill(shapes["params"], seed=7)
    want = np.asarray(jax.jit(lambda p, t: jmod.apply({"params": p}, t, ids, train=False))(
        params, jnp.asarray(tokens)))
    mod.load_state_dict(params_from_jax(params, prefix=""), strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(tokens), torch.tensor(np.asarray(ids))).numpy()
    assert got.shape == want.shape == (2, 6, 64)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("variant", sorted(JAX_TABLES))
def test_override_tables_match_jax(variant):
    """The port Trainer's ``_synthesis_override`` of the model's own table,
    for a test split holding two channels that training lacks, equals JAX's
    ``synthesize_rows`` of the JAX tree's table under every static strategy
    (``random_input_corr`` from equal-seeded generators); ``as_is`` gives
    none, ``fixed_input_corr`` raises in both."""
    r = _run(variant)
    t = Trainer.__new__(Trainer)
    t.cfg, t.model = r["cfg"], r["model"]
    t.mapper = {"train": [0, 1, 2, 3, 4, 5], "test": [0, 6, 2, 7, 5]}
    table = jnp.asarray(r["params"]["backbone"][JAX_TABLES[variant]])
    for strategy in STATIC_STRATEGIES:
        t.host_rng = np.random.default_rng(5)
        if strategy == "fixed_input_corr":
            for fn in (lambda: t._synthesis_override("test", strategy),
                       lambda: jnc.synthesis_plan(t.mapper, "test", "train", strategy)):
                with pytest.raises(ValueError):
                    fn()
            continue
        got = t._synthesis_override("test", strategy)
        if strategy == "as_is":
            assert got is None
            continue
        plan = jnc.synthesis_plan(t.mapper, "test", "train", strategy,
                                  rng=np.random.default_rng(5))
        want = np.asarray(jnc.synthesize_rows(table, plan))
        assert got.shape == want.shape == (5, table.shape[1]), strategy
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7, err_msg=strategy)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_freeze_labels_match_jax(variant):
    r = _run(variant)
    model, params = r["model"], r["params"]
    tree = {"backbone": params["backbone"], "proxies": params["proxies"],
            "classifier_head": params["classifier_head"]}
    for kw in (dict(freeze_other=True), dict(unfreeze_last_n_layers=1),
               dict(unfreeze_last_n_layers=1, unfreeze_first_layer=False),
               dict(unfreeze_last_n_layers=0)):
        jlabels = jfreeze.build_trainable_labels(tree, **kw)
        as_numbers = jax.tree_util.tree_map(
            lambda lab, p: np.full(np.shape(p), 1.0 if lab == "train" else 0.0, np.float32),
            jlabels, tree)
        want = params_from_jax(as_numbers)
        got = build_trainable_labels(model.named_parameters(), **kw)
        assert set(got) <= set(want)
        for name, lab in got.items():
            values = set(np.unique(want[name].numpy()).tolist())
            assert values == {1.0 if lab == "train" else 0.0}, (kw, name, lab, values)
        assert "freeze" in got.values() and "train" in got.values(), kw


def test_samplers_that_read_a_missing_table_raise():
    """DCS reads channel embeddings, ``_proj`` ChannelViT's patch projection:
    ``vit_adapt`` has neither, DepthwiseViT only the first. ``uniform``
    trains every model on k of its channels."""
    x, y = _inputs()
    batch = {"image": torch.from_numpy(x), "label": torch.from_numpy(y)}
    lr = make_lr_schedule("none", 1e-3, {}, num_epochs=1, steps_per_epoch=1)
    for variant, method, refused in (
            ("vit_adapt", "lowest_cosine_prob", "channel_embed"),
            ("vit_adapt", "hcs_per_sample", "channel_embed"),
            ("depthwise_weights", "lowest_cosine_prob_proj", "patch_embed.proj"),
            ("vit_adapt", "uniform", None), ("hypervit", "uniform", None),
            ("depthwise_weights", "lowest_cosine_prob", None)):
        cfg = _configs(variant)[1]
        model = build_model(cfg.model.name, cfg.model, MAPPER, NC, device="cpu")
        state = TrainState(model, make_optimizer("adamw", {"lr": 1e-3}, lr_schedule=lr,
                                                 total_steps=1))
        step = make_train_step(model, channel_ids=IDS, k=2, hcs_method=method, hcs_temp=0.1,
                               generator=torch.Generator().manual_seed(0))
        if refused:
            with pytest.raises(ValueError, match=refused):
                step(state, batch)
        else:
            _, m = step(state, batch)
            assert len(m["sampled_channels"]) == 2 and np.isfinite(float(m["loss"]))
