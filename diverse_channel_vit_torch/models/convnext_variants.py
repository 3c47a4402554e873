"""The ConvNeXt family: six CHAMMI baselines with channel-adaptive stems
(counterpart of the JAX package's ``models/convnext_variants.py``).

Every model puts a stem of its own in front of one ConvNeXt-Tiny trunk
(``models/convnext.py``) and pools its last map (``pooling``). The stems
produce (B, 96, H / 4, W / 4) at stem scale, NCHW:

- ``convnext_base``: one 4x4/4 convolution over ``in_dim`` channels
  (``stem_conv``, ``stem_bias``);
- ``shared_convnext``: one such stem per chunk (``stem_conv_{chunk}``);
- ``sliceparamconvnext``: a (96, C_total, 4, 4) bank sliced by the batch's
  channel ids, plus a per-class-channel embedding (``slice_class_emb``) or
  one column for every channel (``duplicate``);
- ``templatemixingconvnext``: kernels mixed from 64 templates by
  per-channel coefficients (per chunk with ``separate_coef``);
- ``hyperconvnext``: kernels made by a hypernetwork from per-channel
  z-vectors (per chunk with ``separate_emb``);
- ``depthwiseconvnext``: each channel through its own bank of 3x3 kernels,
  the channels pooled (``pooling_channel_type``), then a bias-free 1x1
  convolution and an InstanceNorm.

**Chunk identity.** The stems of some models depend on the chunk a batch
comes from (a per-chunk stem, coefficient table, z table, patch embedding or
pooling table), not only on its channel ids. Their forward takes the chunk
as ``chunk=`` (None: the mapper's first key, JAX's ``chunk_name()``); the
port's steps pass it (``training/steps.py``). Every chunk's parameters exist
in one module, so one optimizer state serves every chunk, as JAX's one
parameter tree serves its per-chunk clones (``bind_chunk``).

The forward returns ``(features, 0.0)``: f32 features of
``pooled_dim(pooling)`` (768 for ``avg``), as the ViTs return their CLS
row. ``channel_embed_override`` replaces the per-channel table of
``templatemixingconvnext`` (coefficients), ``hyperconvnext`` (z-vectors)
and ``depthwiseconvnext`` (the (C, k, 3, 3) kernels), the novel-channel
evals' rows (JAX ``trainer.py:1218-1246``); the other models ignore it, as
JAX's do.

Dtypes follow JAX: the stems' convolutions run in the compute dtype, the
hypernetwork, the template mix, ``FanAttentionV2`` and the InstanceNorm in
f32. MIRO's taps and attention maps need transformer blocks, which these
models lack: the Trainer refuses ``train.miro`` and ``train.plot_attn`` for
them (ROADMAP A9).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.initializers import (conv_patch_, kaiming_normal_, lecun_normal_, normal_,
                                normal_div8_, orthogonal_, trunc_normal_)
from .convnext import SMALL_CONV, TINY, ConvNeXtTrunk, feature_pool, pooled_dim
from .hypernet import HyperNetwork
from .registry import register_model
from .wrappers import ChannelAdaptiveClassifier

STEM_DIM = 96
STEM_KERNEL = 4
POOLING_CHANNEL_TYPES = ("avg", "sum", "weighted_sum_random", "weighted_sum_one",
                         "weighted_sum_random_no_softmax", "weighted_sum_one_no_softmax",
                         "weighted_sum_random_pairwise",
                         "weighted_sum_random_pairwise_no_softmax", "attention")


def _fan_out_stem(in_dim: int, g) -> nn.Parameter:
    """(96, in_dim, 4, 4) at torch ``kaiming_normal_(mode='fan_out')``:
    N(0, 2 / (96 * 16))."""
    return nn.Parameter(kaiming_normal_(torch.empty(STEM_DIM, in_dim, STEM_KERNEL, STEM_KERNEL),
                                  STEM_DIM * STEM_KERNEL * STEM_KERNEL, generator=g))


def adaptive_pool_4x4(y: torch.Tensor, reduce: str) -> torch.Tensor:
    """``reduce`` ("mean" or "amax") over a 4 x 4 grid of bins of the last
    two axes, bin i spanning rows ``[i * h // 4, (i + 1) * h // 4)``: the
    JAX ``_adaptive_pool_4x4``'s edges, which are torch
    ``adaptive_*_pool2d``'s only where 4 divides the size."""
    h, w = y.shape[-2:]
    fn = getattr(torch, reduce)
    rows = torch.stack([fn(y[..., (i * h) // 4:((i + 1) * h) // 4, :], dim=-2)
                        for i in range(4)], dim=-2)
    return torch.stack([fn(rows[..., (j * w) // 4:((j + 1) * w) // 4], dim=-1)
                        for j in range(4)], dim=-1)


class _ConvNeXtCore(nn.Module):
    """The trunk and the pooling; subclasses make the stem (:meth:`stem`)."""

    chunk_aware = True  # the forward takes the batch's chunk (``chunk=``)

    def __init__(self, mapper: dict, num_total_channels: int, *, pooling: str = "avg",
                 is_conv_small: bool = False, include_stem_norm: bool = True,
                 drop_path_rate: float = 0.0, gelu_exact: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mapper = {k: list(v) for k, v in mapper.items()}
        self.num_total_channels = num_total_channels
        self.pooling = pooling
        self.dtype = dtype
        self.drop_path_rate = float(drop_path_rate)
        self.embed_dim = pooled_dim(pooling)
        arch = SMALL_CONV if is_conv_small else TINY
        self.trunk = ConvNeXtTrunk(include_stem_norm=include_stem_norm,
                                   drop_path_rate=drop_path_rate, gelu_exact=gelu_exact,
                                   dtype=dtype, generator=generator, **arch)

    def chunk_name(self, chunk: Optional[str]) -> str:
        return chunk if chunk is not None else next(iter(self.mapper))

    def draw_drop_path(self, batch: int, generator: Optional[torch.Generator] = None,
                       device=None) -> list:
        """DropPath's (B,) keep mask per trunk block, or None per block at
        rate 0 (``ConvNeXtTrunk.draw_drop_path``)."""
        if device is None:
            device = next(self.parameters()).device
        return self.trunk.draw_drop_path(batch, generator, device)

    def token_dropout_on(self) -> bool:
        return False

    def stem(self, x: torch.Tensor, channel_ids: torch.Tensor, override, chunk: str):
        raise NotImplementedError

    def forward(self, x: torch.Tensor, channel_ids: torch.Tensor,
                channel_embed_override: Optional[torch.Tensor] = None, *,
                chunk: Optional[str] = None, taps: Optional[dict] = None,
                drop_path: Optional[list] = None, attention_layer: Optional[int] = None,
                token_drop=None):
        """``drop_path``: the step's masks (:meth:`draw_drop_path`); in
        training without them the masks are drawn here from torch's global
        generator. ``taps`` and ``attention_layer`` need transformer blocks
        and raise."""
        if taps is not None or attention_layer is not None:
            raise NotImplementedError("MIRO taps and attention maps of a ConvNeXt model are "
                                      "not ported (ROADMAP A9)")
        y = self.stem(x, channel_ids, channel_embed_override, self.chunk_name(chunk))
        if self.training and self.drop_path_rate > 0 and drop_path is None:
            drop_path = self.draw_drop_path(x.shape[0], None, x.device)
        y = self.trunk(y, drop_path if self.training else None)
        return feature_pool(y, self.pooling).float(), x.new_zeros((), dtype=torch.float32)


def _conv(x, w, b=None, stride=STEM_KERNEL, dt=torch.float32, **kw):
    return F.conv2d(x.to(dt), w.to(dt), None if b is None else b.to(dt), stride=stride, **kw)


class ConvNeXtBase(_ConvNeXtCore):
    """One 4x4/4 stem over ``in_dim`` channels (``convnext_base.py:14-106``),
    at the ``reinit_as_random`` init until a pretrained stem widens into it
    (``convnext.apply_pretrained_convnext``)."""

    def __init__(self, mapper, num_total_channels, *, in_dim: int = 3, generator=None, **kw):
        super().__init__(mapper, num_total_channels, generator=generator, **kw)
        self.stem_conv = _fan_out_stem(in_dim, generator)
        self.stem_bias = nn.Parameter(torch.zeros(STEM_DIM))

    def stem(self, x, channel_ids, override, chunk):
        return _conv(x, self.stem_conv, self.stem_bias, dt=self.dtype)


class SharedConvNeXt(_ConvNeXtCore):
    """A stem per chunk (Allen 3, HPA 4, CP 5 channels; ``shared_convnext.py:
    29-49``) in front of the shared trunk."""

    def __init__(self, mapper, num_total_channels, *, generator=None, **kw):
        super().__init__(mapper, num_total_channels, generator=generator, **kw)
        for chunk, ids in self.mapper.items():
            self.register_parameter(f"stem_conv_{chunk}", _fan_out_stem(len(ids), generator))
            self.register_parameter(f"stem_bias_{chunk}", nn.Parameter(torch.zeros(STEM_DIM)))

    def stem(self, x, channel_ids, override, chunk):
        return _conv(x, getattr(self, f"stem_conv_{chunk}"), getattr(self, f"stem_bias_{chunk}"),
                     dt=self.dtype)


# SliceParam's per-class-channel embedding columns by CHAMMI chunk
CLASS_EMB_IDX = {"Allen": (0, 1, 2), "HPA": (3, 4, 5, 6), "CP": (7, 8, 9, 10, 11)}


class SliceParamConvNeXt(_ConvNeXtCore):
    """A (96, C_total, 4, 4) bank sliced by channel ids
    (``slice_param_convnext.py:53-56``, :110-123), kaiming fan_in; with
    ``slice_class_emb`` plus the chunk's columns of a (96, 12, 4, 4)
    ``class_emb`` (N(0, 1) / 8); with ``duplicate`` one column for every
    channel."""

    def __init__(self, mapper, num_total_channels, *, slice_class_emb: bool = False,
                 duplicate: bool = False, generator=None, **kw):
        super().__init__(mapper, num_total_channels, generator=generator, **kw)
        self.slice_class_emb, self.duplicate = slice_class_emb, duplicate
        n_bank = 1 if duplicate else num_total_channels
        self.conv1_param_bank = nn.Parameter(kaiming_normal_(
            torch.empty(STEM_DIM, n_bank, STEM_KERNEL, STEM_KERNEL), generator=generator))
        if slice_class_emb and not duplicate:
            self.class_emb = nn.Parameter(normal_div8_(
                torch.empty(STEM_DIM, 12, STEM_KERNEL, STEM_KERNEL), generator))

    def stem(self, x, channel_ids, override, chunk):
        if self.duplicate:
            w = self.conv1_param_bank.expand(-1, x.shape[1], -1, -1)
        else:
            w = self.conv1_param_bank[:, channel_ids]
            if self.slice_class_emb:
                w = w + self.class_emb[:, list(CLASS_EMB_IDX[chunk])]
        return _conv(x, w, dt=self.dtype)


class TemplateMixingConvNeXt(_ConvNeXtCore):
    """Stem kernels ``sum_t coef[c, t] * template[o, t, h, w]``
    (``template_mixing_convnext.py:36-53``, mix :90-103): a (96, T, 4, 4)
    template bank (kaiming fan_in) and orthogonal coefficients, (C_total, T)
    or one (C_chunk, T) table per chunk with ``separate_coef``."""

    def __init__(self, mapper, num_total_channels, *, num_templates: int = 64,
                 separate_coef: bool = False, generator=None, **kw):
        super().__init__(mapper, num_total_channels, generator=generator, **kw)
        g = generator
        self.separate_coef = separate_coef
        self.conv1_param_bank = nn.Parameter(kaiming_normal_(
            torch.empty(STEM_DIM, num_templates, STEM_KERNEL, STEM_KERNEL), generator=g))
        if separate_coef:
            for chunk, ids in self.mapper.items():
                self.register_parameter(f"conv1_coefs_chunk_{chunk}", nn.Parameter(
                    orthogonal_(torch.empty(len(ids), num_templates), generator=g)))
        else:
            self.conv1_coefs = nn.Parameter(orthogonal_(
                torch.empty(num_total_channels, num_templates), generator=g))

    def stem(self, x, channel_ids, override, chunk):
        if override is not None:
            coefs = override
        elif self.separate_coef:
            coefs = getattr(self, f"conv1_coefs_chunk_{chunk}")
        else:
            coefs = self.conv1_coefs[channel_ids]
        w = torch.einsum("ct,othw->ochw", coefs, self.conv1_param_bank)
        return _conv(x, w, dt=self.dtype)


class HyperConvNeXt(_ConvNeXtCore):
    """z-vectors (``conv1_emb`` (C_total, z), N(0, 1) cut at +-2, or one
    N(0, 1) table per chunk with ``separate_emb``) -> ``HyperNetwork`` ->
    (96, C, 4, 4) stem kernels (``hypernet_convnext.py:57-68``, :100-185)."""

    def __init__(self, mapper, num_total_channels, *, z_dim: int = 64, hidden_dim: int = 64,
                 separate_emb: bool = False, generator=None, **kw):
        super().__init__(mapper, num_total_channels, generator=generator, **kw)
        g = generator
        self.separate_emb = separate_emb
        if separate_emb:
            for chunk, ids in self.mapper.items():
                self.register_parameter(f"conv1_emb_chunk_{chunk}",
                                        nn.Parameter(normal_(torch.empty(len(ids), z_dim), 1.0, g)))
        else:
            self.conv1_emb = nn.Parameter(trunc_normal_(
                torch.empty(num_total_channels, z_dim), std=1.0, generator=g))
        self.hypernet = HyperNetwork(z_dim, hidden_dim, STEM_KERNEL, STEM_DIM, 1, generator=g)

    def stem(self, x, channel_ids, override, chunk):
        if override is not None:
            z = override
        elif self.separate_emb:
            z = getattr(self, f"conv1_emb_chunk_{chunk}")
        else:
            z = self.conv1_emb[channel_ids]
        return _conv(x, self.hypernet(z), dt=self.dtype)


class FanAttentionV2(nn.Module):
    """Per-(sample, channel) sigmoid weights (``depthwise_convnext.py:47-66``)
    in f32: q = wq2(relu(wq1(x))), keys the channel mean of x, weight =
    sigmoid(q . keys). x (B, C, D) -> (B, C)."""

    def __init__(self, emb_dim: int, generator=None):
        super().__init__()
        self.wq1 = nn.Linear(emb_dim, emb_dim // 16)
        self.wq2 = nn.Linear(emb_dim // 16, emb_dim)
        with torch.no_grad():
            for lin in (self.wq1, self.wq2):
                lecun_normal_(lin.weight, generator)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        q = self.wq2(torch.relu(self.wq1(x)))
        return torch.sigmoid(torch.einsum("bch,bh->bc", q, x.mean(dim=1)))


class DepthwiseConvNeXt(_ConvNeXtCore):
    """Each channel through its own ``kernels_per_channel`` 3x3 kernels, the
    channels pooled, then a bias-free 1x1 convolution to 96 and an affine
    InstanceNorm as the stem (``depthwise_convnext.py:107-427``).

    CHAMMI (a mapper without ``train``): first a per-chunk depthwise
    ``patch_size`` x ``patch_size`` patch embedding (``patch_emb_{chunk}``,
    torch Conv2d's uniform init, and ``patch_emb_bias_{chunk}``); other
    datasets average-pool by ``patch_size`` when ``reduce_size``. The bank
    ``conv1depthwise_param_bank`` is (C_total * k, 1, 3, 3), kaiming fan_in
    9. ``pooling_channel_type``: ``avg``, ``sum``, the ``weighted_sum_*``
    forms (``weighted_sum_pooling`` (C_total,), N(0, 1) for ``random``, ones
    for ``one``, softmax over the batch's channels unless ``no_softmax``;
    ``pairwise``: a ``weighted_sum_pooling_{chunk}`` table per chunk), or
    ``attention`` (4 x 4 avg and max summaries of each channel's k maps into
    ``FanAttentionV2``, ``attn_pooling``)."""

    def __init__(self, mapper, num_total_channels, *, kernels_per_channel: int = 64,
                 patch_size: int = 4, pooling_channel_type: str = "avg",
                 reduce_size: bool = True, generator=None, **kw):
        super().__init__(mapper, num_total_channels, generator=generator, **kw)
        if pooling_channel_type not in POOLING_CHANNEL_TYPES:
            raise ValueError(f"Invalid pooling_channel_type: {pooling_channel_type}")
        g, k, p = generator, kernels_per_channel, patch_size
        self.kernels_per_channel, self.patch_size = k, p
        self.pooling_channel_type, self.reduce_size = pooling_channel_type, reduce_size
        self.is_chammi = "train" not in self.mapper
        if self.is_chammi:
            for chunk, ids in self.mapper.items():
                self.register_parameter(f"patch_emb_{chunk}", nn.Parameter(
                    conv_patch_(torch.empty(len(ids), 1, p, p), p * p, g)))
                self.register_parameter(f"patch_emb_bias_{chunk}",
                                        nn.Parameter(torch.zeros(len(ids))))
        self.conv1depthwise_param_bank = nn.Parameter(kaiming_normal_(
            torch.empty(num_total_channels * k, 1, 3, 3), 9, generator=g))
        pool = pooling_channel_type
        if pool.startswith("weighted_sum") and "pairwise" not in pool:
            w = torch.empty(num_total_channels)
            self.weighted_sum_pooling = nn.Parameter(normal_(w, 1.0, g) if "random" in pool
                                                     else nn.init.ones_(w))
        elif "pairwise" in pool:
            for chunk, ids in self.mapper.items():
                self.register_parameter(f"weighted_sum_pooling_{chunk}",
                                        nn.Parameter(normal_(torch.empty(len(ids)), 1.0, g)))
        elif pool == "attention":
            self.attn_pooling = FanAttentionV2(k * 32, generator=g)
        self.stem_conv1x1 = nn.Linear(k, STEM_DIM, bias=False)
        lecun_normal_(self.stem_conv1x1.weight, g)
        self.stem_norm_inst = nn.InstanceNorm2d(STEM_DIM, affine=True)

    def stem(self, x, channel_ids, override, chunk):
        b, c = x.shape[:2]
        k, p, dt = self.kernels_per_channel, self.patch_size, self.dtype
        if self.is_chammi:
            x = _conv(x, getattr(self, f"patch_emb_{chunk}"),
                      getattr(self, f"patch_emb_bias_{chunk}"), stride=p, dt=dt, groups=c)
        elif p > 1 and self.reduce_size:
            x = F.avg_pool2d(x.to(dt), p, p)
        bank = (override if override is not None else
                self.conv1depthwise_param_bank.view(self.num_total_channels, k, 3, 3)[channel_ids])
        y = _conv(x, bank.reshape(c * k, 1, 3, 3), stride=1, dt=dt, padding=1, groups=c)
        hp, wp = y.shape[-2:]
        y = y.view(b, c, k, hp, wp)
        pool = self.pooling_channel_type
        if pool == "avg":
            y = y.mean(dim=1)
        elif pool == "sum":
            y = y.sum(dim=1)
        else:
            if pool == "attention":
                summary = torch.cat([adaptive_pool_4x4(y, "mean").reshape(b, c, k, 16),
                                     adaptive_pool_4x4(y, "amax").reshape(b, c, k, 16)], dim=2)
                wsel = self.attn_pooling(summary.reshape(b, c, k * 32))[:, :, None, None, None]
            else:
                wsel = (getattr(self, f"weighted_sum_pooling_{chunk}")[:c] if "pairwise" in pool
                        else self.weighted_sum_pooling[channel_ids])
                if "no_softmax" not in pool:
                    wsel = torch.softmax(wsel, dim=0)
                wsel = wsel[None, :, None, None, None]
            y = (y * wsel.to(y.dtype)).sum(dim=1)
        y = _conv(y, self.stem_conv1x1.weight[:, :, None, None], stride=1, dt=dt)
        w, bias = self.stem_norm_inst.weight, self.stem_norm_inst.bias
        y = F.instance_norm(y.float(), weight=w, bias=bias, eps=self.stem_norm_inst.eps)
        return y.to(dt)


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------

def _pooling(cfg_model) -> str:
    return cfg_model.get("pooling", "avg") or "avg"


def _common(cfg_model, mapper, generator, dtype) -> dict:
    return dict(mapper=mapper, num_total_channels=len(cfg_model.in_channel_names),
                pooling=_pooling(cfg_model),
                is_conv_small=bool(cfg_model.get("is_conv_small", False)),
                drop_path_rate=float(cfg_model.get("drop_path_rate", 0.0) or 0.0),
                gelu_exact=bool(cfg_model.get("gelu_exact", False)), dtype=dtype,
                generator=generator)


def _wrap(backbone: _ConvNeXtCore, cfg_model, mapper: dict, num_classes: int,
          generator) -> ChannelAdaptiveClassifier:
    """The backbone with its proxies and, off CHAMMI, its head (the JAX
    ``_wrap``: ``with_head = "Allen" not in mapper``)."""
    return ChannelAdaptiveClassifier(
        backbone=backbone, embed_dim=backbone.embed_dim, num_classes=num_classes,
        with_head="Allen" not in mapper, learnable_temp=cfg_model.get("learnable_temp", False),
        temperature=cfg_model.get("temperature", 0.11111), generator=generator)


# Every factory reads, as JAX's do: pooling, is_conv_small, drop_path_rate,
# learnable_temp, temperature and in_channel_names, plus its own keys below;
# gelu_exact is the JAX package's process-wide flag, read here from the
# model config. The yaml keys no JAX factory reads (pretrained_model_name,
# enable_sample, sample_by_weights*, separate_norm, num_classes and, except
# for convnext_base, in_dim) are ignored by the port as JAX ignores them;
# pretrained, pretrained_ckpt and init_first_layer are the Trainer's
# (convnext.apply_pretrained_convnext), freeze_other, unfreeze_last_n_layers
# and unfreeze_first_layer too (training/freeze.py).

@register_model("convnext_base")
def convnext_base(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32,
                  generator=None):
    """``in_dim``: the stem's input channels (the first chunk's count when
    unset)."""
    in_dim = cfg_model.get("in_dim") or len(next(iter(mapper.values())))
    bb = ConvNeXtBase(in_dim=in_dim, **_common(cfg_model, mapper, generator, dtype))
    return _wrap(bb, cfg_model, mapper, num_classes, generator)


@register_model("shared_convnext")
def shared_convnext(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32,
                    generator=None):
    bb = SharedConvNeXt(**_common(cfg_model, mapper, generator, dtype))
    return _wrap(bb, cfg_model, mapper, num_classes, generator)


@register_model("sliceparamconvnext")
def sliceparam_convnext(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32,
                        generator=None):
    """``slice_class_emb``, ``duplicate`` (a bank of one column)."""
    common = _common(cfg_model, mapper, generator, dtype)
    duplicate = bool(cfg_model.get("duplicate", False))
    if duplicate:
        common["num_total_channels"] = 1
    bb = SliceParamConvNeXt(slice_class_emb=bool(cfg_model.get("slice_class_emb", False)),
                            duplicate=duplicate, **common)
    return _wrap(bb, cfg_model, mapper, num_classes, generator)


@register_model("templatemixingconvnext")
def template_mixing_convnext(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32,
                             generator=None):
    """``num_templates`` (64 when unset), ``separate_coef``; no stem
    LayerNorm, as the reference drops it here."""
    bb = TemplateMixingConvNeXt(num_templates=cfg_model.get("num_templates") or 64,
                                separate_coef=bool(cfg_model.get("separate_coef", False)),
                                include_stem_norm=False,
                                **_common(cfg_model, mapper, generator, dtype))
    return _wrap(bb, cfg_model, mapper, num_classes, generator)


@register_model("hyperconvnext")
def hyper_convnext(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32,
                   generator=None):
    """``z_dim`` and ``hidden_dim`` (64 each when unset), ``separate_emb``."""
    bb = HyperConvNeXt(z_dim=cfg_model.get("z_dim") or 64,
                       hidden_dim=cfg_model.get("hidden_dim") or 64,
                       separate_emb=bool(cfg_model.get("separate_emb", False)),
                       **_common(cfg_model, mapper, generator, dtype))
    return _wrap(bb, cfg_model, mapper, num_classes, generator)


@register_model("depthwiseconvnext")
def depthwise_convnext(cfg_model, mapper: dict, num_classes: int, dtype=torch.float32,
                       generator=None):
    """``kernels_per_channel`` (64 when unset), ``patch_size`` (4),
    ``pooling_channel_type`` (avg), ``reduce_size``; no stem LayerNorm."""
    bb = DepthwiseConvNeXt(
        kernels_per_channel=cfg_model.get("kernels_per_channel") or 64,
        patch_size=cfg_model.get("patch_size", 4) or 4,
        pooling_channel_type=str(cfg_model.get("pooling_channel_type") or "avg"),
        reduce_size=bool(cfg_model.get("reduce_size", True)), include_stem_norm=False,
        **_common(cfg_model, mapper, generator, dtype))
    return _wrap(bb, cfg_model, mapper, num_classes, generator)
