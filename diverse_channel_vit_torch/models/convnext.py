"""ConvNeXt trunk (counterpart of the JAX package's ``models/convnext.py``).

The reference's ConvNeXt family wraps timm's ``convnext_tiny.fb_in22k``,
keeps ``stages[0..3]`` as a shared trunk and replaces only the stem. The
port builds the trunk itself in timm's parameter layout (``stages.{s}.
downsample.{0,1}``, ``stages.{s}.blocks.{b}.{conv_dw, norm, mlp.fc1,
mlp.fc2, gamma}``), NCHW, so a local timm checkpoint loads by name
(:func:`load_torch_convnext_state`); nothing is downloaded.

ConvNeXt-Tiny: stem Conv 4x4/4 (+ LN); 4 stages of depths (3, 3, 9, 3),
dims (96, 192, 384, 768); a block is depthwise 7x7 conv -> LN -> Linear 4x
-> GELU (tanh, the package default; ``gelu_exact`` for erf) -> Linear ->
layer-scale gamma -> DropPath, added to its input; a downsample is LN +
Conv 2x2/2. The LayerNorms run over the channels of the NHWC view in f32;
the convolutions and the MLP run in the compute ``dtype`` (weights cast to
it), as the JAX trunk's flax modules do, so in bf16 the first stage's
residual stream stays f32 behind the stem LN and the later stages' is bf16.

No TPU kernel lies on this path: JAX leaves every op here to XLA, and the
port to cuDNN and cuBLAS.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.activations import gelu
from ..ops.initializers import trunc_normal_
from .vit import drop_branch

TINY = dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768))
SMALL_CONV = dict(depths=(3, 3, 8, 2), dims=(96, 192, 384, 768))  # is_conv_small


def channel_layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm over the channels of an NCHW tensor, in f32 (timm's
    ``LayerNorm2d``; the JAX trunk's LN over NHWC's last axis)."""
    y = F.layer_norm(x.permute(0, 2, 3, 1).float(), ln.normalized_shape, ln.weight, ln.bias,
                     ln.eps)
    return y.permute(0, 3, 1, 2)


def _conv(x: torch.Tensor, conv: nn.Conv2d, dt: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dt), conv.weight.to(dt), None if conv.bias is None else
                    conv.bias.to(dt), conv.stride, conv.padding, 1, conv.groups)


def _linear(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dt), lin.weight.to(dt), None if lin.bias is None else lin.bias.to(dt))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale_init: float = 1e-6,
                 gelu_exact: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.drop_path, self.gelu_exact, self.dtype = dim, drop_path, gelu_exact, dtype
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: DropPath's (B,) keep mask of this block, or None."""
        dt = self.dtype
        y = _conv(x, self.conv_dw, dt).permute(0, 2, 3, 1)  # NHWC view
        y = F.layer_norm(y.float(), (self.dim,), self.norm.weight, self.norm.bias, self.norm.eps)
        y = gelu(_linear(y, self.mlp.fc1, dt), self.gelu_exact)
        y = _linear(y, self.mlp.fc2, dt) * self.gamma.to(dt)
        y = drop_branch(y, keep, self.drop_path)
        return x + y.permute(0, 3, 1, 2)


class ConvNeXtStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, drop_paths: Sequence[float],
                 gelu_exact: bool, dtype: torch.dtype, downsample: bool):
        super().__init__()
        self.downsample = (nn.Sequential(nn.LayerNorm(in_dim, eps=1e-6),
                                         nn.Conv2d(in_dim, dim, 2, stride=2))
                           if downsample else None)
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim, dpr, gelu_exact=gelu_exact, dtype=dtype)
                                    for dpr in drop_paths[:depth])


class ConvNeXtTrunk(nn.Module):
    """``stages[0..3]`` with the stem LayerNorm in front when
    ``include_stem_norm``: (B, dims[0], H, W) at stem scale -> (B, dims[-1],
    H / 8, W / 8), NCHW. DropPath's rate rises linearly from 0 at the first
    block to ``drop_path_rate`` at the last.

    A deliberate difference from JAX: each downsampling conv (2 x 2, stride
    2) floors an odd grid, as timm's ``convnext_tiny`` does, where JAX's
    ``nn.Conv`` pads it (``SAME``) and keeps one more row and column. On
    even grids (224^2 and 32^2 at every stage) the two agree."""

    def __init__(self, depths: Sequence[int] = TINY["depths"],
                 dims: Sequence[int] = TINY["dims"], include_stem_norm: bool = True,
                 drop_path_rate: float = 0.0, gelu_exact: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.stem_norm = nn.LayerNorm(dims[0], eps=1e-6) if include_stem_norm else None
        total = sum(depths)
        dprs = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.stages = nn.ModuleList()
        start = 0
        for si, (depth, dim) in enumerate(zip(depths, dims)):
            self.stages.append(ConvNeXtStage(dims[si - 1] if si else dim, dim, depth,
                                             dprs[start:start + depth], gelu_exact, dtype,
                                             downsample=si > 0))
            start += depth
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """JAX's init: convolutions and dense kernels trunc-normal(0.02),
        zero biases, LayerNorms (1, 0), layer scale 1e-6."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                trunc_normal_(m.weight, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()

    @property
    def blocks(self) -> list:
        return [blk for stage in self.stages for blk in stage.blocks]

    def draw_drop_path(self, batch: int, generator: Optional[torch.Generator], device) -> list:
        """One (B,) keep mask per block (``uniform < 1 - rate``, as JAX's
        ``bernoulli``) drawn from ``generator`` block by block; None for a
        block at rate 0."""
        return [None if blk.drop_path <= 0.0 else
                torch.rand(batch, generator=generator, device=device) < 1.0 - blk.drop_path
                for blk in self.blocks]

    def forward(self, x: torch.Tensor, drop_path: Optional[list] = None) -> torch.Tensor:
        """``drop_path``: :meth:`draw_drop_path`'s masks (training), or None."""
        x = x.contiguous(memory_format=torch.channels_last)
        if self.stem_norm is not None:
            x = channel_layer_norm(x, self.stem_norm)
        i = 0
        for stage in self.stages:
            if stage.downsample is not None:
                norm, conv = stage.downsample
                x = _conv(channel_layer_norm(x, norm), conv, self.dtype)
            for blk in stage.blocks:
                x = blk(x, None if drop_path is None else drop_path[i])
                i += 1
        return x


def feature_pool(x: torch.Tensor, pooling: str) -> torch.Tensor:
    """Final pooling (``convnext_base.py:89-102``) of an NCHW map: avg / max
    / avg_max / none (the CHW flattening the reference does) -> (B, F)."""
    if pooling == "avg":
        return x.mean(dim=(2, 3))
    if pooling == "max":
        return x.amax(dim=(2, 3))
    if pooling in ("avg_max", "avgmax"):
        return torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=-1)
    if pooling == "none":
        return x.reshape(x.shape[0], -1)
    raise ValueError(f"Pooling {pooling} not supported")


def pooled_dim(pooling: str, dim: int = 768, spatial: int = 7) -> int:
    if pooling in ("avg", "max"):
        return dim
    if pooling in ("avg_max", "avgmax"):
        return 2 * dim
    return spatial * spatial * dim


def initialize_first_conv_layer(stem: torch.Tensor, torch_stem_weight,
                                first_layer) -> torch.Tensor:
    """A pretrained 3-channel stem widened to ``stem``'s input channels
    (reference ``model_utils.py:45-91``, JAX ``initialize_first_conv_layer``).

    ``stem``: the model's (out, in_dim, kh, kw) stem, already at its random
    kaiming fan_out init (what ``reinit_as_random`` keeps);
    ``torch_stem_weight``: the pretrained (out, orig_in, kh, kw).

    - ``reinit_as_random``: ``stem`` unchanged;
    - ``pretrained_pad_random``: pretrained on the first ``orig_in`` input
      channels, random on the rest;
    - ``pretrained_pad_avg``: as above, then channel ``orig_in + i`` gets the
      mean of pretrained channels ``i : n_avg + i`` with ``n_avg = 2 if
      in_dim == 5 else 3`` (the reference's CHAMMI rule, slices clamped to
      the pretrained channels). Past ``in_dim = orig_in + orig_in`` (JUMP-CP's
      8 channels from 3) a window is empty: the reference and the JAX
      package then fill those channels with NaN; the port raises
      ``ValueError`` instead;
    - any other mode, ``pretrained_pad_dups`` included, raises
      ``NotImplementedError`` as the reference does (DUPS exists only for
      SliceParam's bank, :func:`pad_dups_param_bank`).

    ``orig_in == in_dim`` returns the pretrained stem as it is; ``orig_in >
    in_dim`` raises ``ValueError``. Returns a new f32 tensor on ``stem``'s
    device."""
    mode = str(getattr(first_layer, "value", first_layer) or "reinit_as_random")
    if mode == "reinit_as_random":
        return stem
    if mode not in ("pretrained_pad_random", "pretrained_pad_avg"):
        raise NotImplementedError(f"First layer init {mode} not implemented")
    pre = torch.as_tensor(np.asarray(torch_stem_weight, np.float32)).to(stem.device)
    orig_in, in_dim = pre.shape[1], stem.shape[1]
    if orig_in > in_dim:
        raise ValueError(f"pretrained stem has {orig_in} input channels > model in_dim {in_dim}")
    if orig_in == in_dim:
        return pre.clone()
    out = stem.detach().float().clone()
    out[:, :orig_in] = pre
    if mode == "pretrained_pad_avg":
        n_avg = 2 if in_dim == 5 else 3
        if in_dim - orig_in > orig_in:
            raise ValueError(f"init_first_layer=pretrained_pad_avg widens {orig_in} pretrained "
                             f"channels to at most {2 * orig_in}, not {in_dim}: channel "
                             f"{2 * orig_in} would average no channel (NaN in the reference); "
                             "use pretrained_pad_random")
        for i, c in enumerate(range(orig_in, in_dim)):
            out[:, c] = pre[:, i:n_avg + i].mean(dim=1)
    return out


def pad_dups_param_bank(bank: torch.Tensor, torch_stem_weight) -> torch.Tensor:
    """SliceParam's ``pretrained_pad_dups`` bank (``slice_param_convnext.py:
    92-110``): each pretrained input channel repeated in place (einops ``o i
    h w -> o (i d) h w``), cut to the bank's (out, C_total, kh, kw) width."""
    pre = torch.as_tensor(np.asarray(torch_stem_weight, np.float32)).to(bank.device)
    total = bank.shape[1]
    return pre.repeat_interleave(total // pre.shape[1] + 1, dim=1)[:, :total].clone()


_STEM_NORM = {"stem.1.weight": "stem_norm.weight", "stem.1.bias": "stem_norm.bias"}


@torch.no_grad()
def load_torch_convnext_state(trunk: ConvNeXtTrunk, torch_state: dict) -> list:
    """Copy a timm ``convnext_tiny`` state dict's trunk tensors into
    ``trunk`` in place: ``stages.*`` by name (timm's ``mlp.fc1`` and the older
    ``fc1`` spellings both), ``stem.1.*`` into the stem LayerNorm. A key the
    trunk lacks, or one whose shape differs, is skipped and the trunk's
    tensor keeps its init, as JAX does; returns the names loaded."""
    own = dict(trunk.named_parameters())
    loaded = []
    for key, value in torch_state.items():
        name = _STEM_NORM.get(key, key)
        parts = name.split(".")
        if parts[0] == "stages" and len(parts) > 5 and parts[4] in ("fc1", "fc2"):
            name = ".".join(parts[:4] + ["mlp"] + parts[4:])
        p = own.get(name)
        v = torch.as_tensor(np.asarray(value, np.float32))
        if p is None or tuple(p.shape) != tuple(v.shape):
            continue
        p.copy_(v)
        loaded.append(name)
    return loaded


def apply_pretrained_convnext(model: nn.Module, torch_state: dict, model_name: str,
                              init_first_layer=None, mapper: Optional[dict] = None) -> list:
    """Load a local timm ``convnext_tiny`` state dict into a ConvNeXt-family
    classifier in place (the reference's ``create_model(..., pretrained=True)``
    + ``intialize_first_conv_layer``, JAX ``apply_pretrained_convnext``):

    - the trunk by :func:`load_torch_convnext_state`;
    - ``convnext_base``: ``stem_conv`` widened by ``init_first_layer``
      (:func:`initialize_first_conv_layer`), the pretrained stem bias kept;
    - ``shared_convnext``: each chunk's stem widened to its chunk, the bias
      kept per chunk;
    - ``sliceparamconvnext``: ``pretrained_pad_dups`` fills the bank
      (:func:`pad_dups_param_bank`); another mode keeps the random bank;
    - the other models keep their generated or template stems.

    Returns the names of the backbone's tensors it set."""
    fe = model.feature_extractor
    loaded = ["trunk." + n for n in load_torch_convnext_state(fe.trunk, torch_state)]
    stem_w, stem_b = torch_state.get("stem.0.weight"), torch_state.get("stem.0.bias")
    if stem_w is None:
        return loaded
    pairs = []
    if model_name == "convnext_base" and hasattr(fe, "stem_conv"):
        pairs = [("stem_conv", "stem_bias")]
    elif model_name == "shared_convnext":
        pairs = [(f"stem_conv_{c}", f"stem_bias_{c}") for c in (mapper or {})
                 if hasattr(fe, f"stem_conv_{c}")]
    with torch.no_grad():
        for w_name, b_name in pairs:
            w = getattr(fe, w_name)
            w.copy_(initialize_first_conv_layer(w, stem_w, init_first_layer))
            loaded.append(w_name)
            if stem_b is not None:
                getattr(fe, b_name).copy_(torch.as_tensor(np.asarray(stem_b, np.float32)))
                loaded.append(b_name)
        mode = str(getattr(init_first_layer, "value", init_first_layer) or "")
        if (model_name == "sliceparamconvnext" and hasattr(fe, "conv1_param_bank")
                and mode == "pretrained_pad_dups"):
            fe.conv1_param_bank.copy_(pad_dups_param_bank(fe.conv1_param_bank, stem_w))
            loaded.append("conv1_param_bank")
    return loaded
