"""Trainer — the run orchestrator (counterpart of the JAX package's
``trainer.py``).

Builds loaders, model, optimizer, schedules and logger in ``__init__``,
then runs the epoch loop with evaluation and checkpoints, as the JAX
Trainer does for JUMP-CP, So2Sat, CHAMMI, CIFAR and the synthetic config,
for every model the JAX package registers (DiChaViT, ChannelViT, the
baselines ``vit_adapt``, ``depthwisevit_adapt``, ``hypervit_adapt`` and
``templatemixingvit``, and the six ConvNeXt models):

- the channel-count draw of DCS (``k ~ U[1, C]``) comes from the numpy
  ``host_rng`` seeded with ``train.seed``, one step function per k, all
  drawing their channels from one ``torch.Generator`` on the device;
- the prefetch thread copies each batch to the device in the compute
  dtype, on the device's default stream, which the step uses too;
- eval counts correct answers under each batch's ``valid`` mask; the pad
  rows of a ``pad_last`` batch are dropped before the forward (the mask
  excludes them anyway), so a small eval split costs one small forward
  whatever the eval batch size;
- eval runs each split once per strategy of ``model.new_channel_inits``
  (a split whose channels are train's once, ``valid`` once, with no
  strategy), each strategy's synthesized channel embeddings passed to the
  forward as its override (``ops/novel_channels.py``); with
  ``eval.eval_subset_channels`` it then sweeps the first test split's
  channel subsets of sizes C and C - 1;
- CHAMMI (``morphem70k``) trains on the mixed-chunk loader's batches with
  the proxy loss: one grad micro-batch per chunk in the batch's order, each
  with its own k draw, summed in ``.grad``, then one update; its eval dumps
  every test chunk's features and runs the MorphEm kNN benchmark
  (``evaluation/morphem_eval.py``), ``accuracy`` being the CHAMMI score,
  once per strategy of ``model.new_channel_inits`` when the run trained on
  a ``train.training_chunks`` subset;
- a ConvNeXt model whose stem depends on the chunk (per-chunk stems and
  tables) gets each CHAMMI micro-batch's chunk and each test chunk's in the
  eval (JAX ``bind_chunk``); single-chunk datasets leave it to the model
  (the mapper's first key), as JAX's ``_default_chunk`` does;
- a checkpoint is ``training/checkpoint.py``'s torch file and meta.json;
- the runtime of JAX ``trainer.py``: ``model.pretrained`` (a warm start from
  a local reference checkpoint, ``models/import_torch.py``; for a ConvNeXt
  model a local timm ``convnext_tiny`` state dict, its stem widened by
  ``model.init_first_layer``, ``models/convnext.py``); freezing
  (``model.freeze_other``, ``model.unfreeze_last_n_layers``,
  ``training/freeze.py``); MIRO (``train.miro``, ``miro_ld``,
  ``miro_lr_mult``, ``training/miro.py``); SWA (averaged once an epoch past
  ``train.swa_start``) and SWAD (once a batch, under its frozen-then-cosine
  lr), whose average the model adopts at the end of the run; a SIGTERM
  (``training/preemption.py``) saves ``model_preempt`` in the stable
  directory ``<checkpoints>/<dataset>/preempt--seed{seed}``, with the
  epoch and batch it stopped at, the host and torch generators' states, the
  channel counter and the SWA average, and the next launch with
  ``train.auto_resume`` re-enters the run there, mid-epoch included, to the
  bit (the directory goes on a clean finish); ``train.max_host_rss_gb``
  saves that checkpoint and re-executes the process when the host's RSS
  passes it at an epoch boundary; ``train.profile_dir`` writes a
  ``torch.profiler`` trace of the run; ``train.plot_attn`` saves the last
  block's CLS attention for 8 eval images at every evaluation.

The device is the caller's ``device``, else ``hardware.device`` (``cuda``
in the port's config tree; ``cpu`` only when asked). Every key this slice
does not honour raises ``NotImplementedError`` naming its ROADMAP item
(:func:`check_supported`). ``async_checkpoint`` saves synchronously and
``donate_state`` changes nothing.
"""

from __future__ import annotations

import itertools
import math
import os
import shutil
import sys
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from .data import (get_classes, get_train_val_test_loaders, make_random_instance_train_loader,
                   prefetch)
from .device import resolve_device
from .logging_utils import MyLogging
from .models import build_model
from .ops.novel_channels import (dynamic_input_corr, flatten_training_channels, synthesis_plan,
                                 synthesize_rows)
from .ops.patch_embed import per_channel_patch_embed
from .training import (TrainState, make_eval_step, make_grad_step, make_lr_schedule,
                       make_optimizer, make_train_step)
from .training.checkpoint import (load_checkpoint, load_meta, load_tree, save_checkpoint,
                                  save_tree)
from .training.preemption import PreemptionGuard
from .training.schedules import swad_schedule
from .utils.misc import AverageMeter, Timer, set_seeds


def _default(val, fallback):
    return fallback if val is None else val


def _host_rss_mb() -> Optional[float]:
    """This process's resident set size in MB from ``/proc/self/status``
    (None off Linux), as the JAX Trainer reads it."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024
    except OSError:
        pass
    return None


def _as_dict(section) -> dict:
    return section.to_dict() if hasattr(section, "to_dict") else dict(section or {})


def chunk_names(cfg) -> list:
    """The chunks of ``data_chunk.chunks``, in order."""
    return [next(iter(_as_dict(e))) for e in cfg.data_chunk.chunks]


def build_mapper(cfg) -> dict:
    """chunk -> global-channel-id mapper from the config alone (the JAX
    ``build_mapper``; the reference's hard-coded CHAMMI maps,
    ``trainer.py:128-150``); other datasets read the split dict of
    ``data_chunk.chunks[0]``."""
    if cfg.dataset.name == "morphem70k":
        if len(cfg.dataset.in_channel_names) == 12:
            return {"Allen": [0, 1, 2], "HPA": [3, 4, 5, 6], "CP": [7, 8, 9, 10, 11]}
        return {"Allen": [5, 2, 6], "HPA": [3, 6, 5, 0], "CP": [5, 0, 7, 1, 4]}
    entry = _as_dict(cfg.data_chunk.chunks[0])
    return dict(entry[next(iter(entry))])


def training_chunk_list(cfg):
    """``train.training_chunks`` as a list of chunks, or None for all."""
    tc = cfg.train.get("training_chunks")
    if tc in (None, "train"):
        return None
    return [c for c in str(tc).split("_") if c]


# the ConvNeXt factories, by the ``name:`` keys of their yaml files in
# ``config/configs/model/`` (two file names differ from theirs:
# sliceparam.yaml, template_mixing_conv.yaml)
CONVNEXT_MODELS = ("convnext_base", "shared_convnext", "sliceparamconvnext",
                   "templatemixingconvnext", "hyperconvnext", "depthwiseconvnext")


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for each key the port's Trainer does
    not honour yet, naming its ROADMAP item, and ``ValueError`` for
    ``train.plot_attn`` on a ConvNeXt model, which has no attention. A model
    name that no package registers is left to the registry's ``KeyError``."""
    tr, model, hw = cfg.train, cfg.model, cfg.hardware
    convnext = str(model.get("name")) in CONVNEXT_MODELS
    if convnext and tr.get("plot_attn"):
        raise ValueError(f"train.plot_attn: model {model.get('name')!r} has no attention to "
                         "plot (the JAX Trainer fails there too)")
    refusals = [
        (bool(tr.get("ssl")), "train.ssl (ROADMAP A6)"),
        (convnext and bool(tr.get("miro")),
         "train.miro for a ConvNeXt model: its block taps (ROADMAP A9)"),
        (any(int(v) > 1 for v in _as_dict(hw.get("mesh") or {}).values()),
         "hardware.mesh with more than one device (ROADMAP A10)"),
        (bool(hw.get("zero1")) or bool(hw.get("zero3")), "hardware.zero1 / zero3 (ROADMAP A10)"),
    ]
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"{what} is not ported yet")


def _pretrained_path(cfg) -> Optional[str]:
    """``model.pretrained`` as a path, or True with ``model.pretrained_ckpt``
    (JAX ``trainer.py:352-357``); None for no warm start."""
    pre = cfg.model.get("pretrained")
    return pre if isinstance(pre, str) else (cfg.model.get("pretrained_ckpt") if pre else None)


def _trainer_device(cfg, device) -> torch.device:
    if device is None:
        device = cfg.hardware.get("device") or "cuda"
        if str(device).split(":")[0] not in ("cuda", "cpu"):
            raise ValueError(f"hardware.device={device!r}: the port runs on 'cuda' (or 'cpu' "
                             "when asked)")
    return resolve_device(device)


class Trainer:
    def __init__(self, cfg, device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = _trainer_device(cfg, device)
        check_supported(cfg)
        self.debug = bool(cfg.train.get("debug", False))
        self.seed = int(_default(cfg.train.get("seed"), 1234))
        self.host_rng = set_seeds(self.seed)
        self.dataset_name = cfg.dataset.name
        self.logger = MyLogging(cfg)
        dtype_name = cfg.train.get("dtype", "bfloat16")
        if cfg.train.get("use_amp", False):
            dtype_name = "bfloat16"  # AMP flag parity: bf16 compute
        self.dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32

        # -- chunk (CHAMMI) or split -> channel-id mapper (_build_mapper) ----
        self.chammi = self.dataset_name == "morphem70k"
        self.all_chunks = chunk_names(cfg)
        self.chunk = self.all_chunks[0]
        self.mapper = build_mapper(cfg)
        if not self.chammi:
            # single-chunk datasets train on the lone "train" split; JAX
            # resets the key so (trainer.py:578-580), and only CHAMMI's
            # dataset reads train.tps_prob
            cfg.train.training_chunks = "train"

        # auto-size the eval batch to the card's memory when unset (reference
        # trainer.py:93-105: 512 at 14 GB, scaled and rounded to a power of 2;
        # depthwise models cap at 128); 16 GB off the card, as JAX on the CPU
        if not cfg.eval.get("batch_size"):
            if "depthwise" not in str(cfg.model.name):
                mem_gb = 16.0
                if self.device.type == "cuda":
                    mem_gb = torch.cuda.get_device_properties(self.device).total_memory / (1 << 30)
                ebs = 2 ** int(math.log2(max(int(512 * mem_gb / 14), 1)))
            else:
                ebs = 128
            cfg.eval.batch_size = ebs

        # -- data ------------------------------------------------------------
        self._build_dataset()
        train_classes, _ = get_classes(self.dataset_name, cfg.dataset.get("file_name") or "",
                                       training_chunks=training_chunk_list(cfg),
                                       root_dir=cfg.dataset.get("root_dir") or "")
        self.num_classes = (int(cfg.dataset.get("num_classes", 10)) if train_classes is None
                            else len(train_classes))

        # -- model ---------------------------------------------------------
        # the reference fills model.in_channel_names from the dataset; a
        # YAML placeholder string counts as unset
        icn = cfg.model.get("in_channel_names")
        if not icn or isinstance(icn, str):
            cfg.model.in_channel_names = cfg.dataset.in_channel_names
        # the attn_pooling config group goes to the factories that take it
        # (JAX trainer.py:236-241)
        attn_pooling = cfg.get("attn_pooling")
        self.model = build_model(cfg.model.name, cfg.model, self.mapper, self.num_classes,
                                 device=self.device, dtype=self.dtype, seed=self.seed,
                                 attn_pooling=None if attn_pooling is None
                                 else _as_dict(attn_pooling))
        self.learnable_temp = bool(cfg.model.get("learnable_temp", False))
        self.temperature = float(cfg.model.get("temperature", 0.11111))
        self.extra_loss_lambda = float(cfg.train.get("extra_loss_lambda", 0.0) or 0.0)
        self.hcs_enabled = bool(cfg.model.get("enable_sample", False))
        self.hcs_method = cfg.model.get("hcs_sampling", "none") or "none"
        self.hcs_temp = float(cfg.model.get("hcs_sampling_temp", 0.1) or 0.1)
        # CHAMMI trains with the proxy loss, single-chunk classification with
        # CE on the head (trainer.py:251-253)
        self.loss_type = "proxy" if self.chammi else "ce"

        # -- schedules / optimizer ------------------------------------------
        self.updates_per_epoch = max(1, len(self.train_loader))
        self.total_epochs = int(cfg.train.num_epochs)
        opt_params = _as_dict(cfg.optimizer.get("params", {}))
        sched_params = _as_dict(cfg.scheduler.get("params", {}))
        self.lr_schedule = make_lr_schedule(
            cfg.scheduler.get("name", "none"), float(opt_params.get("lr", 1e-3)), sched_params,
            num_epochs=self.total_epochs, steps_per_epoch=self.updates_per_epoch,
            convert_to_batch=bool(cfg.scheduler.get("convert_to_batch", False)),
        )
        # SWA / SWAD (JAX trainer.py:273-307): plain SWA averages once an
        # epoch past swa_start under the base schedule; SWAD once a batch,
        # under the base lr frozen at the last update of epoch swa_start and
        # then cosine-annealed to swa_lr
        self.swa = bool(cfg.train.get("swa", False))
        self.swad = bool(cfg.train.get("swad", False))
        self.swa_start = int(cfg.train.get("swa_start", 5) or 5)
        if self.swad:
            self.lr_schedule = swad_schedule(self.lr_schedule,
                                             self.swa_start * self.updates_per_epoch,
                                             float(cfg.train.get("swa_lr", 0.05) or 0.05))
        self.swa_params: Optional[list] = None
        self.swa_n = 0
        self.channel_counter: Dict[int, int] = {}
        if int(cfg.train.get("adaptive_interface_epochs", 0) or 0) > 0:
            # parity: the reference raises the same (trainer.py:338-339)
            raise NotImplementedError("currently turn this off: 'adaptive_interface_epochs > 0'")
        self.tx = make_optimizer(
            cfg.optimizer.get("name", "adamw"), opt_params, lr_schedule=self.lr_schedule,
            total_steps=self.total_epochs * self.updates_per_epoch,
            clip_grad_norm=cfg.train.get("clip_grad_norm"),
        )
        self._warm_start()
        frozen = self._frozen_names()
        # MIRO (trainer.py:443-460): the pre-featurizer is a frozen copy of
        # the weights as they are now; the encoders ride on the model
        self.miro = bool(cfg.train.get("miro", False))
        self.miro_ld = float(cfg.train.get("miro_ld", 0.01) or 0.01)
        self.miro_pre = None
        if self.miro:
            from .training.miro import MIRO_KEY, init_encoders, pre_featurizer

            self.miro_pre = pre_featurizer(self.model)
            setattr(self.model, MIRO_KEY, init_encoders(self.model))
        self.state = TrainState(self.model, self.tx, frozen=frozen, miro_lr_mult=float(
            cfg.train.get("miro_lr_mult", 10.0) or 10.0))
        n_params = sum(p.numel() for p in self.state.params)
        self.logger.info(f"model {cfg.model.name}: {n_params:,} params ({len(frozen)} tensors "
                         f"frozen), device {self.device}, dtype {dtype_name}")

        # -- step caches: one train step per (channels, k), all drawing from
        # one generator on the device --------------------------------------
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self._train_steps: Dict = {}
        self._grad_steps: Dict = {}
        self._eval_step = make_eval_step(self.model)
        self.eval_counts: Dict[str, tuple] = {}
        self._dyn_bank: Optional[torch.Tensor] = None

        # -- checkpoints -----------------------------------------------------
        root = os.path.join(cfg.train.get("checkpoints", "checkpoints"), self.dataset_name)
        self.checkpoints = os.path.join(
            root, time.strftime("%Y-%b-%d-%H-%M-%S") + f"--seed{self.seed}")
        self.start_epoch = 1
        if cfg.train.get("resume_train") and cfg.train.get("resume_model"):
            self.state, last_epoch = load_checkpoint(
                os.path.dirname(cfg.train.resume_model), self.state,
                name=os.path.basename(cfg.train.resume_model),
            )
            self.start_epoch = last_epoch + 1
            self.logger.info(f"resumed from {cfg.train.resume_model} at epoch {last_epoch}")
        # preemption recovery: the run directories are timestamped, so the
        # SIGTERM checkpoint lives at a stable (dataset, seed) path that the
        # next launch finds
        self.preempt_dir = os.path.join(root, f"preempt--seed{self.seed}")
        self._preempt_guard: Optional[PreemptionGuard] = None
        self._epoch_interrupted = False
        self._interrupted_at_batch = 0
        self._resume_start_batch = 0
        if (cfg.train.get("auto_resume", True) and self.start_epoch == 1
                and os.path.exists(os.path.join(self.preempt_dir, "model_preempt"))):
            self._auto_resume()

    def _warm_start(self) -> None:
        """``model.pretrained``: load every tensor of a local reference
        checkpoint that fits the model; the rest keep their fresh init
        (JAX ``trainer.py:371-400``). Raises ``ValueError`` when none fits."""
        path = _pretrained_path(self.cfg)
        if not path:
            return
        if self.cfg.model.name in CONVNEXT_MODELS:
            from .models.convnext import apply_pretrained_convnext
            from .models.resnet import load_state_dict_file

            loaded = apply_pretrained_convnext(
                self.model, load_state_dict_file(str(path)), self.cfg.model.name,
                init_first_layer=self.cfg.model.get("init_first_layer"), mapper=self.mapper)
            self.logger.info(f"loaded pretrained ConvNeXt weights from {path} "
                             f"({len(loaded)} tensors)")
            return
        from .models.import_torch import load_reference_checkpoint, merge_into_template

        imported, _ = load_reference_checkpoint(path)
        loaded, kept = merge_into_template(self.model, imported)
        if not loaded:
            raise ValueError(f"model.pretrained={path}: no tensor of the checkpoint fits model "
                             f"{self.cfg.model.name!r}; wrong model or geometry?")
        msg = f"imported {len(loaded)} tensors from reference checkpoint {path}"
        if kept:
            msg += f"; kept fresh init for {len(kept)}: {sorted(kept)[:6]}" + (
                " ..." if len(kept) > 6 else "")
        self.logger.info(msg)

    def _frozen_names(self) -> set:
        """The parameters ``model.freeze_other`` / ``unfreeze_last_n_layers``
        freeze (JAX ``trainer.py:401-414``)."""
        freeze_other = bool(self.cfg.model.get("freeze_other", False))
        last_n = int(_default(self.cfg.model.get("unfreeze_last_n_layers"), -1))
        if not freeze_other and last_n < 0:
            return set()
        from .training.freeze import build_trainable_labels, frozen_names

        return frozen_names(build_trainable_labels(
            self.model.named_parameters(), freeze_other=freeze_other,
            unfreeze_last_n_layers=last_n,
            unfreeze_first_layer=bool(self.cfg.model.get("unfreeze_first_layer", True))))

    def _auto_resume(self) -> None:
        """Re-enter a preempted run from ``model_preempt`` (JAX
        ``trainer.py:485-540``): the state, the epoch and batch it stopped
        at, the host generator, the torch generators, the channel counter
        and the SWA average. Batch order and the loaders' augmentation are
        functions of (seed, epoch, index), so the rest of the run is the
        uninterrupted run's."""
        self.state, last_epoch = load_checkpoint(self.preempt_dir, self.state,
                                                 name="model_preempt")
        self.start_epoch = last_epoch + 1
        meta = load_meta(self.preempt_dir, "model_preempt")
        if meta.get("resume_epoch") is not None and self.cfg.train.get("resume_mid_epoch", True):
            self.start_epoch = int(meta["resume_epoch"])
            self._resume_start_batch = int(meta.get("resume_batch") or 0)
        if meta.get("host_rng_state") is not None:
            self.host_rng.bit_generator.state = meta["host_rng_state"]
        for c, n in (meta.get("channel_counter") or {}).items():
            self.channel_counter[int(c)] = int(n)
        extra = load_tree(self.preempt_dir, "model_preempt_extra") or {}
        if "generator" in extra:
            self.generator.set_state(extra["generator"])
        if "torch_cpu" in extra:
            torch.set_rng_state(extra["torch_cpu"])
        if "torch_cuda" in extra and self.device.type == "cuda":
            torch.cuda.set_rng_state(extra["torch_cuda"], self.device)
        if meta.get("swa_n") and "swa" in extra:
            self.swa_params = [t.to(self.device) for t in extra["swa"]]
            self.swa_n = int(meta["swa_n"])
        mid = (f", re-entering epoch {self.start_epoch} at batch {self._resume_start_batch}"
               if self._resume_start_batch else "")
        self.logger.info(f"auto-resumed from preemption checkpoint at epoch {last_epoch}{mid} "
                         f"({self.preempt_dir})")

    def _build_dataset(self):
        """The loaders (``trainer.py:592-622``). A single-chunk dataset: the
        chunk's train, valid and test loaders (the test loader a dict of
        loaders for several test channel subsets, So2Sat's test_1 / test_2
        / test_full). CHAMMI: every chunk's test loader, over all of the
        chunk's rows, and the mixed-chunk train loader (JAX's ``SHUFFLE_ALL``)
        over the training chunks, ``train.tps_prob`` on its datasets."""
        cfg = self.cfg
        if not self.chammi:
            self.train_loader, self.val_loader, self.test_loader = get_train_val_test_loaders(
                cfg, self.chunk, self.seed)
            return
        self.test_loaders = {}
        for chunk in self.all_chunks:
            _, _, self.test_loaders[chunk] = get_train_val_test_loaders(
                cfg, chunk, self.seed, with_train=False)
        self.train_loader = make_random_instance_train_loader(
            cfg, self.seed, training_chunks=training_chunk_list(cfg))
        self.val_loader = self.test_loader = None

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------

    def _chunk_channel_ids(self, chunk_or_split: str):
        return list(self.mapper[chunk_or_split])

    def bound_chunk(self, chunk: Optional[str]) -> Optional[str]:
        """The ``chunk=`` a step or eval forward passes: the CHAMMI chunk for a
        model whose stem depends on it (the ConvNeXt family's
        ``chunk_aware``), else None (JAX ``bind_chunk``)."""
        return chunk if getattr(self.model.feature_extractor, "chunk_aware", False) else None

    def _draw_k(self, c: int) -> Optional[int]:
        """HCS channel-count draw Cin_new ~ U[1, C] (``channel_vit.py:79-82``)."""
        if not self.hcs_enabled:
            return None
        return int(self.host_rng.integers(1, c + 1))

    def _get_train_step(self, channel_ids, k):
        key = (tuple(channel_ids), k)
        if key not in self._train_steps:
            self._train_steps[key] = make_train_step(
                self.model, channel_ids=channel_ids, k=k, hcs_method=self.hcs_method,
                hcs_temp=self.hcs_temp, generator=self.generator, loss_type=self.loss_type,
                extra_loss_lambda=self.extra_loss_lambda, learnable_temp=self.learnable_temp,
                temperature=self.temperature, augment_fn=self._device_augment_fn(),
                **self._step_kw(),
            )
        return self._train_steps[key]

    def _get_grad_step(self, channel_ids, k, chunk=None):
        key = (tuple(channel_ids), k, chunk)
        if key not in self._grad_steps:
            self._grad_steps[key] = make_grad_step(
                self.model, channel_ids=channel_ids, k=k, hcs_method=self.hcs_method,
                hcs_temp=self.hcs_temp, generator=self.generator, loss_type=self.loss_type,
                extra_loss_lambda=self.extra_loss_lambda, learnable_temp=self.learnable_temp,
                temperature=self.temperature, chunk=chunk, **self._step_kw(),
            )
        return self._grad_steps[key]

    def _step_kw(self) -> dict:
        return dict(miro_pre=self.miro_pre, miro_ld=self.miro_ld if self.miro else 0.0,
                    feature_fn=self._hcs_feature_fn())

    def _hcs_feature_fn(self):
        """The frozen ResNet-34 channel scorer of ``hcs_sampling=*_resnet34``
        (JAX ``trainer.py:700-739``; reference ``dichavit.py:68-79``,
        ``:162-167``): ``x`` (B, C, H, W) -> (B, C, 512) features of each
        channel replicated to RGB, in the model's dtype, for the step's
        batch-mean cosine scores. The reference downloads timm's pretrained
        ResNet-34; the port reads a local torchvision-layout state dict from
        ``model.resnet34_ckpt`` and otherwise starts from a random init,
        seeded by the run's seed, and says so. None for other samplers."""
        if not (self.hcs_method or "").endswith("_resnet34"):
            return None
        if getattr(self, "_resnet34_fn", None) is None:
            from .models.resnet import (RESNET34_LAYERS, ResNetFeatures, load_state_dict_file,
                                        load_torch_resnet_state, per_channel_features)

            net = ResNetFeatures(RESNET34_LAYERS, dtype=self.dtype,
                                 generator=torch.Generator().manual_seed(self.seed))
            ckpt = self.cfg.model.get("resnet34_ckpt")
            if ckpt:
                load_torch_resnet_state(net, load_state_dict_file(str(ckpt)))
                self.logger.info(f"hcs resnet34 scorer: weights from {ckpt}")
            else:
                self.logger.info(
                    "hcs resnet34 scorer: model.resnet34_ckpt unset — "
                    "random-init backbone (provide a local torchvision "
                    "resnet34 state dict for reference-equivalent sampling)")
            net.to(self.device)
            self._resnet34_fn = lambda x, _net=net: per_channel_features(_net, x)
        return self._resnet34_fn

    def _device_augment_fn(self):
        """On-device JUMP-CP augmentation when the loader ships raw crops."""
        if self.dataset_name != "jump_cp" or not self.cfg.train.get("device_augment", False):
            return None
        if not getattr(self.train_loader.dataset, "device_augment", False):
            return None
        from .data.normalization import get_mean_std_dataset
        from .ops.augment import jumpcp_train_augment

        mean, std = get_mean_std_dataset("jump_cp")
        img_size = int(self.cfg.dataset.get("img_size", 224))

        def fn(generator, imgs):
            return jumpcp_train_augment(generator, imgs, mean, std, img_size=img_size)

        return fn

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def train(self) -> float:
        timer = Timer()
        best_acc, best_epoch = 0.0, 0
        ev = self.cfg.eval
        try:
            self._preempt_guard = PreemptionGuard().install()
        except ValueError:  # signal.signal outside the main thread: unguarded
            self._preempt_guard = PreemptionGuard()
        # the guard leaves on every way out, an exception included: a raise
        # that left the handler installed would turn SIGTERM into a flag
        # nobody polls for the rest of the process
        try:
            profile_dir = self.cfg.train.get("profile_dir")
            prof = self._start_profile() if profile_dir else None
            # pre-training evaluation (trainer.py:329-333)
            if (not self.debug and not ev.get("skip_eval_first_epoch", False)
                    and not ev.get("only_eval_first_and_last", False) and self.start_epoch == 1):
                eval0 = self.evaluate_model(0)
                self.logger.info({f"eval/{k}": v for k, v in eval0.items()} | {"epoch": 0},
                                 pref_msg="[eval 0]")
            for epoch in range(self.start_epoch, self.total_epochs + 1):
                self._epoch_interrupted = False
                start_batch = self._resume_start_batch if epoch == self.start_epoch else 0
                # a whole epoch is train_one_epoch(epoch), the signature
                # before resume points existed
                train_metrics = (self.train_one_epoch(epoch, start_batch=start_batch)
                                 if start_batch else self.train_one_epoch(epoch))
                if self._preempt_guard.triggered:
                    # an interrupted epoch resumes where it stopped: the
                    # checkpoint records (epoch, batch) and the generators
                    completed = epoch - 1 if self._epoch_interrupted else epoch
                    self._save_preempt(
                        completed, resume_epoch=epoch if self._epoch_interrupted else None,
                        resume_batch=(self._interrupted_at_batch if self._epoch_interrupted
                                      else None))
                    self._stop_profile(prof)
                    self._preempt_guard.restore()
                    self.logger.finish(f"preempted during epoch {epoch}; checkpoint saved for "
                                       "auto-resume")
                    return best_acc
                lr = float(self.lr_schedule(self.state.step))
                self.logger.info({f"train/{k}": v for k, v in train_metrics.items()}
                                 | {"epoch": epoch, "lr": lr},
                                 pref_msg=f"[epoch {epoch}/{self.total_epochs}]")
                if self.cfg.train.get("log_memory", False):
                    self._log_memory()
                if self.channel_counter:
                    self.logger.info({f"channel_usage/{c}": n
                                      for c, n in sorted(self.channel_counter.items())})
                every_n = int(ev.get("every_n_epochs", 1) or 1)
                is_last = epoch == self.total_epochs
                if (epoch % every_n == 0 or is_last) and not (
                        self.debug and ev.get("skip_eval_for_debug", False)):
                    if not (ev.get("only_eval_first_and_last", False)
                            and not (epoch == 1 or is_last)):
                        eval_metrics = self.evaluate_model(epoch)
                        acc = eval_metrics.get("accuracy", 0.0)
                        if acc > best_acc:
                            best_acc, best_epoch = acc, epoch  # BestResult tracker
                        self.logger.info({f"eval/{k}": v for k, v in eval_metrics.items()}
                                         | {"epoch": epoch}, pref_msg=f"[eval {epoch}]")
                self._maybe_save(epoch, best_acc)
                done = epoch - self.start_epoch + 1
                eta = timer.eta(done, self.total_epochs - self.start_epoch + 1)
                self.logger.info(f"epoch {epoch} done in {timer.lap():.1f}s, ETA {eta:.0f}s")
                if self._should_recycle(epoch):
                    # host-RSS recycling (trainer.py:912-944): save the stable
                    # checkpoint, re-execute this process, and the relaunch
                    # resumes at the next epoch
                    self._save_preempt(epoch)
                    self._stop_profile(prof)
                    self._preempt_guard.restore()
                    self.logger.finish(f"host RSS over train.max_host_rss_gb after epoch {epoch}: "
                                       f"recycling the process (auto-resume continues at epoch "
                                       f"{epoch + 1})")
                    self._reexec()
                    return best_acc  # reached only when _reexec is stubbed
            self._stop_profile(prof)
            if (self.swa or self.swad) and self.swa_params is not None:
                # adopt the averaged weights (trainer.py:899-902), in place
                with torch.no_grad():
                    torch._foreach_copy_(self.state.params, self.swa_params)
                self.logger.info(f"adopted SWA weights (averaged over {self.swa_n} updates)")
            self._preempt_guard.restore()
            # a clean finish: the stable-path SIGTERM checkpoint must not shadow
            # the next fresh launch of this (dataset, seed)
            shutil.rmtree(self.preempt_dir, ignore_errors=True)
            self.logger.finish(f"training done: best_acc={best_acc:.4f} (epoch {best_epoch})")
            return best_acc
        finally:
            self._preempt_guard.restore()

    def _start_profile(self):
        """``train.profile_dir``: a ``torch.profiler`` trace of the run, host
        and device activity, from here to the run's end or its preemption
        (JAX ``trainer.py:787-791``)."""
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if prof is None:
            return
        prof.stop()
        out_dir = str(self.cfg.train.profile_dir)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"torch_trace_seed{self.seed}_"
                                     f"{time.strftime('%Y%m%d-%H%M%S')}.json")
        prof.export_chrome_trace(path)
        self.logger.info(f"profiler trace written to {path}")

    def _should_recycle(self, epoch: int) -> bool:
        """True when the host's RSS passes ``train.max_host_rss_gb`` at this
        epoch boundary and recycling is safe: auto_resume on (else the
        relaunch would start over), not the last epoch, not debug."""
        cap = self.cfg.train.get("max_host_rss_gb")
        if not cap or epoch >= self.total_epochs or self.debug:
            return False
        if not self.cfg.train.get("auto_resume", True):
            return False
        rss = _host_rss_mb()
        if rss is None or rss / 1024 <= float(cap):
            return False
        self.logger.info(f"host RSS {rss / 1024:.2f} GB > train.max_host_rss_gb={float(cap):g}")
        return True

    def _reexec(self):  # pragma: no cover (the tests stub it)
        """Replace this process with a fresh launch of the same command
        (``python -m ...`` included: ``sys.orig_argv``)."""
        sys.stdout.flush()
        sys.stderr.flush()
        os.execv(sys.executable, [sys.executable] + sys.orig_argv[1:])

    def _save_preempt(self, last_completed_epoch: int, *, resume_epoch=None,
                      resume_batch=None) -> None:
        """The preemption checkpoint in the stable directory (JAX
        ``trainer.py:946-977``): the train state, and beside it what an
        exact continuation needs: where the run stopped, the host generator
        (the k draws), the channel counter, the torch generators (the
        step's on the device, torch's CPU one and, on a card, its CUDA one)
        and the SWA average."""
        if self.debug:
            return
        meta = {
            "resume_epoch": None if resume_epoch is None else int(resume_epoch),
            "resume_batch": None if resume_batch is None else int(resume_batch),
            "host_rng_state": self.host_rng.bit_generator.state,
            "channel_counter": {str(c): int(n) for c, n in self.channel_counter.items()},
            "swa_n": int(self.swa_n),
        }
        save_checkpoint(self.preempt_dir, self.state, epoch=max(int(last_completed_epoch), 0),
                        config=self.cfg.to_dict(), name="model_preempt", extra_meta=meta)
        extra = {"generator": self.generator.get_state(), "torch_cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            extra["torch_cuda"] = torch.cuda.get_rng_state(self.device)
        if self.swa_params is not None:
            extra["swa"] = [t.detach().cpu() for t in self.swa_params]
        save_tree(self.preempt_dir, "model_preempt_extra", extra)
        where = (f"mid-epoch at (epoch {resume_epoch}, batch {resume_batch})"
                 if resume_epoch is not None else f"last completed epoch {last_completed_epoch}")
        self.logger.info(f"preemption checkpoint saved ({where}) -> {self.preempt_dir}")

    @torch.no_grad()
    def _swa_update(self) -> None:
        """AveragedModel's equal average (``trainer.py:979-989``): the first
        call copies the parameters, then avg += (p - avg) / (n + 1). In
        place on the average only; the live parameters are untouched."""
        if self.swa_params is None:
            self.swa_params = [p.detach().clone() for p in self.state.params]
        else:
            diff = torch._foreach_sub(self.state.params, self.swa_params)
            torch._foreach_div_(diff, self.swa_n + 1.0)
            torch._foreach_add_(self.swa_params, diff)
        self.swa_n += 1

    def _log_memory(self) -> None:
        """Once an epoch, JAX's keys (``trainer.py:835-853``): the card's
        live and peak allocated MB on a card, the host's RSS on every device;
        nothing when neither is known."""
        mem = {}
        if self.device.type == "cuda":
            mem["mem/hbm_mb"] = round(torch.cuda.memory_allocated(self.device) / 2**20, 1)
            mem["mem/hbm_peak_mb"] = round(
                torch.cuda.max_memory_allocated(self.device) / 2**20, 1)
        rss = _host_rss_mb()
        if rss is not None:
            mem["mem/host_rss_mb"] = round(rss, 1)
        if mem:
            self.logger.info(mem)

    def train_one_epoch(self, epoch: int, start_batch: int = 0) -> Dict[str, float]:
        """One epoch from batch ``start_batch`` (a preempted epoch's resume
        point; the loader skips the prefix without fetching it). A SIGTERM
        stops it before the next batch runs."""
        loader = self.train_loader
        loader.set_epoch(epoch)
        # the device copy happens inside the prefetch thread so it overlaps
        # the running step; images ship in the compute dtype
        host_iter = loader.iter_batches(start_batch) if start_batch else iter(loader)
        loader_iter = prefetch(map(self._to_device, host_iter), depth=2)
        meters: Dict[str, AverageMeter] = {}
        max_batches = 3 if self.debug else math.inf
        n_images = n_warmup = 0
        t_first_step_done = None  # exclude the first step from imgs/sec
        for i, batch in enumerate(loader_iter, start=start_batch):
            if i >= max_batches:
                break
            if self._preempt_guard is not None and self._preempt_guard.triggered:
                # batch i has not run: the resumed epoch starts here
                self._epoch_interrupted = True
                self._interrupted_at_batch = i
                break
            if self.chammi:
                metrics = self._train_one_batch_morphem(batch)
                n_images += sum(b["image"].shape[0] for b in batch.values())
            else:
                metrics = self._train_one_batch_regular(batch)
                n_images += batch["image"].shape[0]
            if t_first_step_done is None:
                t_first_step_done = time.perf_counter()
                n_warmup = n_images
            if self.swad and epoch > self.swa_start:
                self._swa_update()  # SWAD averages once a batch
            for c in metrics.pop("sampled_channels", ()):
                # HCS/DCS channel-usage histogram (trainer.py:796-804)
                self.channel_counter[int(c)] = self.channel_counter.get(int(c), 0) + 1
            for k, v in metrics.items():
                meters.setdefault(k, AverageMeter(k)).update(v)
            if (i + 1) % int(self.cfg.train.get("verbose_batches", 50)) == 0:
                self.logger.info({k: round(m.avg, 5) for k, m in meters.items()},
                                 pref_msg=f"  [e{epoch} b{i + 1}/{len(loader)}]")
        if self.swa and not self.swad and epoch > self.swa_start and not self._epoch_interrupted:
            self._swa_update()  # plain SWA averages once an epoch
        self._log_pooling_weights()
        out = {k: m.avg for k, m in meters.items()}
        if t_first_step_done is not None and n_images > n_warmup:
            steady = time.perf_counter() - t_first_step_done
            if steady > 0:
                out["imgs_per_sec_per_chip"] = (n_images - n_warmup) / steady
        return out

    def _log_pooling_weights(self) -> None:
        """The learned channel-pooling weights, once an epoch (JAX
        ``trainer.py:1063-1075``; reference ``trainer.py:816-820``):
        DepthwiseConvNeXt's ``weighted_sum_pooling`` table(s) and
        DepthwiseViT's ``channel_weights``, as ``weights/{name}/w_{i}``."""
        logged = {}
        for name, p in self.model.feature_extractor.named_parameters():
            if name.startswith("weighted_sum_pooling") or name == "channel_weights":
                for i, w in enumerate(p.detach().float().cpu().reshape(-1).tolist()):
                    logged[f"weights/{name}/w_{i}"] = round(float(w), 5)
        if logged:
            self.logger.info(logged)

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch on the device, images in the compute dtype (JAX
        ``_device_batch``); a CHAMMI batch ``{chunk: batch}`` chunk by chunk.
        It runs in the prefetch thread; the copies are synchronous and on the
        device's default stream, the step's."""
        if "image" not in batch:
            return {chunk: self._to_device(sub) for chunk, sub in batch.items()}
        img = torch.from_numpy(batch["image"])
        if self.dtype == torch.bfloat16 and img.dtype == torch.float32:
            img = img.to(torch.bfloat16)
        return {"image": img.to(self.device), "label": torch.from_numpy(batch["label"]).to(
            self.device)}

    def _train_one_batch_regular(self, batch) -> Dict[str, object]:
        cids = self._chunk_channel_ids("train")
        k = self._draw_k(len(cids))
        step = self._get_train_step(cids, k)
        self.state, metrics = step(self.state, batch)
        # one host readback for the whole metrics dict
        sampled = metrics.pop("sampled_channels", None)
        names = sorted(metrics)
        values = torch.stack([metrics[n].float() for n in names]).tolist()
        out: Dict[str, object] = dict(zip(names, values))
        if sampled is not None:
            out["sampled_channels"] = sampled.tolist()
        return out

    def _train_one_batch_morphem(self, batch) -> Dict[str, object]:
        """A mixed CHAMMI batch (``trainer.py:1111-1141``): per chunk, in the
        batch's order, a k draw and a grad micro-batch into ``.grad``; then
        one update. Metrics ``{chunk}/{name}``, ``grad_norm`` (the summed
        gradient's, before clipping) and ``loss``, the chunks' sum."""
        self.state.zero_grad()
        per_chunk, sampled = {}, []
        for chunk, sub in batch.items():
            cids = self._chunk_channel_ids(chunk)
            k = self._draw_k(len(cids))
            metrics = self._get_grad_step(cids, k, self.bound_chunk(chunk))(sub)
            cs = metrics.pop("sampled_channels", None)
            if cs is not None:
                sampled.append(cs)
            per_chunk.update({f"{chunk}/{n}": v for n, v in metrics.items()})
        gnorm = self.state.apply_gradients()
        # one host readback for the whole metrics dict
        names = sorted(per_chunk)
        values = torch.stack([per_chunk[n].float() for n in names] + [gnorm.float()]).tolist()
        out: Dict[str, object] = dict(zip(names, values[:-1]))
        out["grad_norm"] = values[-1]
        out["loss"] = sum(v for n, v in out.items() if n.endswith("/loss"))
        if sampled:
            # global channel ids from every chunk feed one counter
            out["sampled_channels"] = torch.cat(sampled).tolist()
        return out

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def evaluate_model(self, epoch: int) -> Dict[str, float]:
        """``trainer.py:1187-1218``. CHAMMI: the MorphEm eval, once per
        strategy of ``model.new_channel_inits`` (keys prefixed
        ``{strategy}/``, ``accuracy`` the first strategy's) when the run
        trained on a chunk subset, once with no strategy otherwise. Else
        :meth:`eval_regular`, then with ``eval.eval_subset_channels`` the
        channel-subset sweep. With ``train.plot_attn`` it first saves the
        attention maps (:meth:`plot_attention`)."""
        if self.cfg.train.get("plot_attn", False):
            self.plot_attention(epoch)
        if self.chammi:
            from .evaluation.morphem_eval import eval_morphem70k

            subset = training_chunk_list(self.cfg)
            ncis = list(self.cfg.model.get("new_channel_inits") or [None])
            if subset is None or set(subset) >= set(self.all_chunks):
                ncis = [None]
            results: Dict[str, float] = {}
            for nci in ncis:
                res = eval_morphem70k(self, epoch, new_channel_init=nci)
                prefix = "" if nci is None else f"{nci}/"
                results.update({f"{prefix}{k}": v for k, v in res.items()})
            if "accuracy" not in results and f"{ncis[0]}/accuracy" in results:
                results["accuracy"] = results[f"{ncis[0]}/accuracy"]
            return results
        results = self.eval_regular(epoch)
        if self.cfg.eval.get("eval_subset_channels", False):
            results.update(self.eval_subset_channels())
        return results

    def plot_attention(self, epoch: int) -> Optional[str]:
        """``train.plot_attn`` (JAX ``trainer.py:1143-1186``): the last
        block's dense attention probabilities for the first 8 images of the
        first eval batch (``valid``, else ``test``; CHAMMI: the first
        chunk's test loader); saves the CLS row over the valid tokens,
        ``cls_attn_epoch{epoch}.npy`` (B, H, N - 1), under
        ``<checkpoints>/attn``, and, where matplotlib imports, the head- and
        image-mean map per channel as ``cls_attn_epoch{epoch}.png``, whose
        path it returns."""
        from .models.channel_vit import attention_maps

        if self.chammi:
            split = self.all_chunks[0]
            loader = self.test_loaders[split]
        else:
            split = "valid" if self._eval_loader_for("valid") is not None else "test"
            loader = self._eval_loader_for(split)
        if loader is None:
            return None
        batch = next(iter(loader))
        x = torch.from_numpy(np.ascontiguousarray(batch["image"][:8])).to(self.device)
        cids = self._chunk_channel_ids(split if split in self.mapper else "train")
        probs, n_valid = attention_maps(self.model, x, torch.tensor(cids, device=self.device))
        cls_attn = probs[:, :, 0, 1:n_valid].cpu().numpy()  # (B, H, N - 1)
        out_dir = os.path.join(self.checkpoints, "attn")
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, f"cls_attn_epoch{epoch}.npy"), cls_attn)
        try:
            import matplotlib
        except ImportError:
            self.logger.info("plot_attn: matplotlib does not import; saved the .npy only")
            return None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        c = len(cids)
        side = int(math.isqrt(cls_attn.shape[-1] // c))
        if c * side * side != cls_attn.shape[-1]:
            self.logger.info("plot_attn: the last block's grid is pruned (EViT), so it has no "
                             "per-channel map; saved the .npy only")
            return None
        mean_attn = cls_attn.mean(axis=(0, 1)).reshape(c, side, side)
        fig, axes = plt.subplots(1, c, figsize=(2.2 * c, 2.4))
        for ci, ax in enumerate(np.atleast_1d(axes)):
            ax.imshow(mean_attn[ci])
            ax.set_title(f"ch {cids[ci]}", fontsize=8)
            ax.axis("off")
        path = os.path.join(out_dir, f"cls_attn_epoch{epoch}.png")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path

    # the per-channel table the synthesis strategies rebuild, per model, by
    # its name in the backbone (JAX ``trainer.py:1219-1229``)
    OVERRIDE_TABLES = {"dichavit": "patch_embed.channel_embed.weight",
                       "channelvit_adapt": "patch_embed.channel_embed.weight",
                       "depthwisevit_adapt": "channel_embed",
                       "hypervit_adapt": "conv1_emb",
                       "templatemixingvit": "conv1_coefs",
                       "hyperconvnext": "conv1_emb",
                       "templatemixingconvnext": "conv1_coefs",
                       "depthwiseconvnext": "conv1depthwise_param_bank"}

    def _training_channels(self) -> list:
        return flatten_training_channels(self.mapper,
                                         self.cfg.train.get("training_chunks") or "train")

    def _channel_embed(self) -> torch.Tensor:
        """The model's own override table: ChannelViT's channel embeddings
        (C_total, D), DepthwiseViT's, the z-vectors (C_total, z_dim) of
        HyperViT and HyperConvNeXt, the coefficients (C_total, T) of
        TemplateMixingViT and TemplateMixingConvNeXt, or DepthwiseConvNeXt's
        kernels as (C_total, k, 3, 3) (JAX ``trainer.py:1244-1246``). A
        ConvNeXt model built with per-chunk tables (``separate_coef``,
        ``separate_emb``) has no such table and raises ``AttributeError``,
        where JAX raises ``KeyError``."""
        name = self.OVERRIDE_TABLES[self.cfg.model.name]
        fe = self.model.feature_extractor
        table = fe.get_parameter(name).detach()
        if self.cfg.model.name == "depthwiseconvnext":
            table = table.reshape(-1, fe.kernels_per_channel, 3, 3)
        return table

    def _synthesis_override(self, split: str, new_channel_init) -> Optional[torch.Tensor]:
        """The rows of the model's table (:meth:`_channel_embed`) for
        ``split``'s channels under a leave-one-out strategy
        (``trainer.py:1231-1250``), or None for no strategy, ``as_is`` or a
        model without a table (``vit_adapt``). ``random_input_corr``
        draws from ``host_rng`` as JAX does, so later k draws stay JAX's. An
        unknown strategy, a dynamic one included, raises at the first novel
        channel, and ``fixed_input_corr`` always does (no channel map)."""
        if new_channel_init in (None, "as_is") or self.cfg.model.name not in self.OVERRIDE_TABLES:
            return None
        plan = synthesis_plan(self.mapper, split,
                              self.cfg.train.get("training_chunks") or "train",
                              str(new_channel_init), rng=self.host_rng)
        return synthesize_rows(self._channel_embed(), plan)

    def _dynamic_bank(self) -> torch.Tensor:
        """The exemplars of the dynamic strategies (``trainer.py:1252-1278``):
        up to 8 images of the first train batch of the loader's current
        epoch, cut to the training channels, f32 on the device. Taking the
        batch leaves the loader's epoch as it is: its order is f(seed,
        epoch), so the epochs' batches stay JAX's."""
        if self._dyn_bank is None:
            imgs = next(iter(self.train_loader))["image"][:8]
            imgs = imgs[:, :len(self._training_channels())]
            self._dyn_bank = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device)
        return self._dyn_bank

    def _dynamic_override(self, split: str, strategy: str, x: torch.Tensor) -> torch.Tensor:
        """The per-sample (B, C, D) override of ``dynamic_input_corr_{1..6}``
        for the images ``x`` (``trainer.py:1280-1305``): a trained channel's
        own row, a novel channel's :func:`dynamic_input_corr` row. They need
        channel embeddings, and variants 5 and 6 ChannelViT's patch
        projection too: another model raises ``ValueError`` (JAX
        ``KeyError``)."""
        variant = int(str(strategy)[-1])
        training_channels = self._training_channels()
        fe = self.model.feature_extractor
        table = self.OVERRIDE_TABLES.get(self.cfg.model.name, "")
        if not table.startswith(("patch_embed.channel_embed", "channel_embed")) or (
                variant in (5, 6) and not hasattr(fe, "patch_embed")):
            raise ValueError(f"new_channel_inits={strategy!r} reads the channel embeddings"
                             f"{' and the patch projection' if variant in (5, 6) else ''}, "
                             f"which model {self.cfg.model.name!r} does not have")
        ce = self._channel_embed()
        proj_fn = None
        if variant in (5, 6):
            p = fe.patch_size
            kernel = fe.patch_embed.proj.weight.detach().reshape(fe.embed_dim, p * p).t()

            def proj_fn(xx):
                return per_channel_patch_embed(xx, kernel, None, patch_size=p)
        rows = []
        for i, c in enumerate(self._chunk_channel_ids(split)):
            if c in training_channels:
                rows.append(ce[c].expand(x.shape[0], -1))
            else:
                rows.append(dynamic_input_corr(variant, x, i, self._dynamic_bank(), ce,
                                               training_channels, proj_fn=proj_fn))
        return torch.stack(rows, dim=1)

    def eval_regular(self, epoch: int) -> Dict[str, float]:
        """Accuracy per eval split and novel-channel strategy
        (``trainer.py:1307-1330``): each split once per strategy of
        ``model.new_channel_inits``, stopping after the first where the
        split's channels are train's; ``valid`` once with no strategy. Keys
        ``{split}/accuracy`` or ``{split}/{strategy}/accuracy``; ``accuracy``
        their mean."""
        results: Dict[str, float] = {}
        ncis = list(self.cfg.model.get("new_channel_inits") or [None])
        for split in [s for s in self.mapper if s != "train"]:
            loader = self._eval_loader_for(split)
            if loader is None:
                continue
            for i, nci in enumerate(ncis):
                if i > 0 and list(self.mapper["train"]) == list(self.mapper[split]):
                    break
                if split == "valid":
                    nci = None
                key = f"{split}/accuracy" if nci is None else f"{split}/{nci}/accuracy"
                results[key] = self._eval_split(split, loader, nci)
                if split == "valid":
                    break
        if results:
            results["accuracy"] = float(np.mean(list(results.values())))
        return results

    def _eval_loader_for(self, split: str):
        if split == "valid":
            return self.val_loader
        if isinstance(self.test_loader, dict):
            return self.test_loader.get(split)
        return self.test_loader if split.startswith("test") else None

    def _eval_batches(self, loader):
        """Each eval batch's valid rows on the device and their labels; the
        pad rows of a ``pad_last`` batch are dropped before the forward.
        ``debug`` stops after 3 batches."""
        max_batches = 3 if self.debug else math.inf
        for i, batch in enumerate(loader):
            if i >= max_batches:
                break
            valid = batch.get("valid", np.ones(len(batch["label"]), bool))
            rows = np.flatnonzero(valid)
            img = batch["image"] if len(rows) == len(valid) else batch["image"][rows]
            yield (torch.from_numpy(np.ascontiguousarray(img)).to(self.device),
                   batch["label"][rows])

    def _eval_split(self, split: str, loader, new_channel_init=None) -> float:
        """One split's accuracy under one strategy (``trainer.py:1343-1369``);
        a dynamic strategy's override is made per batch from its valid rows."""
        cids = torch.tensor(self._chunk_channel_ids(split if split in self.mapper else "train"),
                            device=self.device)
        dynamic = str(new_channel_init).startswith("dynamic_input_corr")
        override = None if dynamic else self._synthesis_override(split, new_channel_init)
        correct, total = 0, 0
        for x, labels in self._eval_batches(loader):
            if dynamic:
                override = self._dynamic_override(split, new_channel_init, x)
            pred = self._eval_step(x, cids, override).argmax(dim=-1).cpu().numpy()
            correct += int((pred == labels).sum())
            total += len(labels)
        self.eval_counts[split] = (correct, total)
        return correct / max(total, 1)

    def eval_subset_channels(self) -> Dict[str, float]:
        """Channel-robustness sweep (``trainer.py:1383-1429``): the accuracy
        of the first ``test*`` split over every C-choose-n channel subset
        for n = C, then C - 1, where the reference stops. Keys
        ``subset_{n}/mean`` and ``subset_{n}/std`` (population std). Each
        eval batch is loaded once and forwarded for every subset."""
        split = next((s for s in self.mapper if s.startswith("test")), "test")
        loader = self._eval_loader_for(split)
        if loader is None:
            return {}
        full = self._chunk_channel_ids(split if split in self.mapper else "train")
        c = len(full)
        combos = [combo for n in (c, c - 1) if n > 0
                  for combo in itertools.combinations(range(c), n)]
        cids = {combo: torch.tensor([full[i] for i in combo], device=self.device)
                for combo in combos}
        counts = dict.fromkeys(combos, (0, 0))
        for x, labels in self._eval_batches(loader):
            for combo in combos:
                xs = x if len(combo) == c else x[:, list(combo)]
                pred = self._eval_step(xs, cids[combo]).argmax(dim=-1).cpu().numpy()
                correct, total = counts[combo]
                counts[combo] = (correct + int((pred == labels).sum()), total + len(labels))
        results: Dict[str, float] = {}
        for n in (c, c - 1):
            accs = [correct / max(total, 1) for combo, (correct, total) in counts.items()
                    if len(combo) == n]
            if accs:
                results[f"subset_{n}/mean"] = float(np.mean(accs))
                results[f"subset_{n}/std"] = float(np.std(accs))
        return results

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def _maybe_save(self, epoch: int, accuracy: float):
        if self.debug:
            return
        policy = self.cfg.train.get("save_model", "last")
        if policy in (None, "none", "~"):
            return
        if policy == "best":
            # parity: the reference raises too (trainer.py:364-365)
            raise NotImplementedError("save_model='best' not implemented yet")
        if policy == "last" and epoch != self.total_epochs:
            return
        if isinstance(policy, str) and policy.startswith("every"):
            n = int(policy.split("-")[-1]) if "-" in policy else 1
            if epoch % n != 0 and epoch != self.total_epochs:
                return
        name = "model_last" if policy == "last" else f"model_epoch{epoch}"
        save_checkpoint(self.checkpoints, self.state, epoch=epoch, accuracy=accuracy,
                        config=self.cfg.to_dict(), name=name)
