"""Trainer — the run orchestrator (counterpart of the JAX package's
``trainer.py``).

Builds loaders, model, optimizer, schedules and logger in ``__init__``,
then runs the epoch loop with evaluation and checkpoints, as the JAX
Trainer does for JUMP-CP, So2Sat, CHAMMI and the synthetic config:

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
- a checkpoint is ``training/checkpoint.py``'s torch file and meta.json.

The device is the caller's ``device``, else ``hardware.device`` (``cuda``
in the port's config tree; ``cpu`` only when asked). Every key this slice
does not honour raises ``NotImplementedError`` naming its ROADMAP item
(:func:`check_supported`). ``async_checkpoint`` saves synchronously and
``donate_state`` changes nothing; ``auto_resume`` finds nothing to resume,
since no preemption checkpoint is written until preemption is ported.
"""

from __future__ import annotations

import itertools
import math
import os
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
from .ops.sampling import NOT_PORTED
from .training import (TrainState, make_eval_step, make_grad_step, make_lr_schedule,
                       make_optimizer, make_train_step)
from .training.checkpoint import load_checkpoint, save_checkpoint
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


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for each key the port's Trainer does
    not honour yet, naming its ROADMAP item."""
    tr, model, ev, hw = cfg.train, cfg.model, cfg.eval, cfg.hardware
    name = cfg.dataset.name
    chammi = name == "morphem70k"
    refusals = [
        (name in ("cifar10", "cifar100"), f"dataset {name!r}: the CIFAR loader downloads "
                                          "through torchvision and is left out (ROADMAP A6)"),
        (bool(tr.get("swa")) or bool(tr.get("swad")), "train.swa / train.swad (ROADMAP A6)"),
        (bool(tr.get("miro")), "train.miro (ROADMAP A6, A4.5)"),
        (bool(tr.get("ssl")), "train.ssl (ROADMAP A6)"),
        (bool(model.get("freeze_other")), "model.freeze_other (ROADMAP A6 freeze)"),
        (int(_default(model.get("unfreeze_last_n_layers"), -1)) >= 0,
         "model.unfreeze_last_n_layers >= 0 (ROADMAP A6 freeze)"),
        (bool(model.get("pretrained")), "model.pretrained: weight import (ROADMAP A9, A11)"),
        (chammi and bool(ev.get("umap")), "eval.umap: the embedding figures (ROADMAP A7)"),
        (bool(tr.get("plot_attn")), "train.plot_attn (ROADMAP A6)"),
        (bool(tr.get("profile_dir")), "train.profile_dir (ROADMAP A6)"),
        (bool(tr.get("max_host_rss_gb")), "train.max_host_rss_gb: RSS recycling (ROADMAP A6)"),
        (any(int(v) > 1 for v in _as_dict(hw.get("mesh") or {}).values()),
         "hardware.mesh with more than one device (ROADMAP A10)"),
        (bool(hw.get("zero1")) or bool(hw.get("zero3")), "hardware.zero1 / zero3 (ROADMAP A10)"),
        (not bool(_default(model.get("fused_block"), True)),
         "model.fused_block: false, the process-wide unfused route (ROADMAP A6)"),
        (cfg.get("attn_pooling") is not None, "attn_pooling: channel attention pooling "
                                              "(ROADMAP A8.3)"),
        (bool(model.get("enable_sample")) and model.get("hcs_sampling") in NOT_PORTED,
         f"model.hcs_sampling={model.get('hcs_sampling')!r} (ROADMAP A4)"),
    ]
    for refused, what in refusals:
        if refused:
            raise NotImplementedError(f"{what} is not ported yet")


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
                                       training_chunks=training_chunk_list(cfg))
        self.num_classes = (int(cfg.dataset.get("num_classes", 10)) if train_classes is None
                            else len(train_classes))

        # -- model ---------------------------------------------------------
        # the reference fills model.in_channel_names from the dataset; a
        # YAML placeholder string counts as unset
        icn = cfg.model.get("in_channel_names")
        if not icn or isinstance(icn, str):
            cfg.model.in_channel_names = cfg.dataset.in_channel_names
        self.model = build_model(cfg.model.name, cfg.model, self.mapper, self.num_classes,
                                 device=self.device, dtype=self.dtype, seed=self.seed)
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
        self.channel_counter: Dict[int, int] = {}
        if int(cfg.train.get("adaptive_interface_epochs", 0) or 0) > 0:
            # parity: the reference raises the same (trainer.py:338-339)
            raise NotImplementedError("currently turn this off: 'adaptive_interface_epochs > 0'")
        self.tx = make_optimizer(
            cfg.optimizer.get("name", "adamw"), opt_params, lr_schedule=self.lr_schedule,
            total_steps=self.total_epochs * self.updates_per_epoch,
            clip_grad_norm=cfg.train.get("clip_grad_norm"),
        )
        self.state = TrainState(self.model, self.tx)
        n_params = sum(p.numel() for p in self.state.params)
        self.logger.info(f"model {cfg.model.name}: {n_params:,} params, device {self.device}, "
                         f"dtype {dtype_name}")

        # -- step caches: one train step per (channels, k), all drawing from
        # one generator on the device --------------------------------------
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self._train_steps: Dict = {}
        self._grad_steps: Dict = {}
        self._eval_step = make_eval_step(self.model)
        self.eval_counts: Dict[str, tuple] = {}
        self._dyn_bank: Optional[torch.Tensor] = None

        # -- checkpoints -----------------------------------------------------
        self.checkpoints = os.path.join(
            cfg.train.get("checkpoints", "checkpoints"), self.dataset_name,
            time.strftime("%Y-%b-%d-%H-%M-%S") + f"--seed{self.seed}",
        )
        self.start_epoch = 1
        if cfg.train.get("resume_train") and cfg.train.get("resume_model"):
            self.state, last_epoch = load_checkpoint(
                os.path.dirname(cfg.train.resume_model), self.state,
                name=os.path.basename(cfg.train.resume_model),
            )
            self.start_epoch = last_epoch + 1
            self.logger.info(f"resumed from {cfg.train.resume_model} at epoch {last_epoch}")
        if cfg.train.get("auto_resume", True) and self.start_epoch == 1:
            self.logger.info("train.auto_resume: the port writes no preemption checkpoint yet "
                             "(ROADMAP A6), so there is nothing to resume")

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
            )
        return self._train_steps[key]

    def _get_grad_step(self, channel_ids, k):
        key = (tuple(channel_ids), k)
        if key not in self._grad_steps:
            self._grad_steps[key] = make_grad_step(
                self.model, channel_ids=channel_ids, k=k, hcs_method=self.hcs_method,
                hcs_temp=self.hcs_temp, generator=self.generator, loss_type=self.loss_type,
                extra_loss_lambda=self.extra_loss_lambda, learnable_temp=self.learnable_temp,
                temperature=self.temperature,
            )
        return self._grad_steps[key]

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
        # pre-training evaluation (trainer.py:329-333)
        if (not self.debug and not ev.get("skip_eval_first_epoch", False)
                and not ev.get("only_eval_first_and_last", False) and self.start_epoch == 1):
            eval0 = self.evaluate_model(0)
            self.logger.info({f"eval/{k}": v for k, v in eval0.items()} | {"epoch": 0},
                             pref_msg="[eval 0]")
        for epoch in range(self.start_epoch, self.total_epochs + 1):
            train_metrics = self.train_one_epoch(epoch)
            self.logger.info({f"train/{k}": v for k, v in train_metrics.items()}
                             | {"epoch": epoch, "lr": float(self.lr_schedule(self.state.step))},
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
                if not (ev.get("only_eval_first_and_last", False) and not (epoch == 1 or is_last)):
                    eval_metrics = self.evaluate_model(epoch)
                    acc = eval_metrics.get("accuracy", 0.0)
                    if acc > best_acc:
                        best_acc, best_epoch = acc, epoch  # BestResult tracker
                    self.logger.info({f"eval/{k}": v for k, v in eval_metrics.items()}
                                     | {"epoch": epoch}, pref_msg=f"[eval {epoch}]")
            self._maybe_save(epoch, best_acc)
            done = epoch - self.start_epoch + 1
            self.logger.info(f"epoch {epoch} done in {timer.lap():.1f}s, ETA "
                             f"{timer.eta(done, self.total_epochs - self.start_epoch + 1):.0f}s")
        self.logger.finish(f"training done: best_acc={best_acc:.4f} (epoch {best_epoch})")
        return best_acc

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

    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        loader = self.train_loader
        loader.set_epoch(epoch)
        # the device copy happens inside the prefetch thread so it overlaps
        # the running step; images ship in the compute dtype
        loader_iter = prefetch(map(self._to_device, iter(loader)), depth=2)
        meters: Dict[str, AverageMeter] = {}
        max_batches = 3 if self.debug else math.inf
        n_images = n_warmup = 0
        t_first_step_done = None  # exclude the first step from imgs/sec
        for i, batch in enumerate(loader_iter):
            if i >= max_batches:
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
            for c in metrics.pop("sampled_channels", ()):
                # HCS/DCS channel-usage histogram (trainer.py:796-804)
                self.channel_counter[int(c)] = self.channel_counter.get(int(c), 0) + 1
            for k, v in metrics.items():
                meters.setdefault(k, AverageMeter(k)).update(v)
            if (i + 1) % int(self.cfg.train.get("verbose_batches", 50)) == 0:
                self.logger.info({k: round(m.avg, 5) for k, m in meters.items()},
                                 pref_msg=f"  [e{epoch} b{i + 1}/{len(loader)}]")
        out = {k: m.avg for k, m in meters.items()}
        if t_first_step_done is not None and n_images > n_warmup:
            steady = time.perf_counter() - t_first_step_done
            if steady > 0:
                out["imgs_per_sec_per_chip"] = (n_images - n_warmup) / steady
        return out

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
        self.state.optimizer.zero_grad(set_to_none=True)
        per_chunk, sampled = {}, []
        for chunk, sub in batch.items():
            cids = self._chunk_channel_ids(chunk)
            k = self._draw_k(len(cids))
            metrics = self._get_grad_step(cids, k)(sub)
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
        channel-subset sweep."""
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

    # the per-channel table the synthesis strategies rebuild, per model
    # (``trainer.py:1220``; the port registers these two models)
    OVERRIDE_TABLES = {"dichavit": "channel_embed", "channelvit_adapt": "channel_embed"}

    def _training_channels(self) -> list:
        return flatten_training_channels(self.mapper,
                                         self.cfg.train.get("training_chunks") or "train")

    def _channel_embed(self) -> torch.Tensor:
        return self.model.feature_extractor.patch_embed.channel_embed.weight.detach()

    def _synthesis_override(self, split: str, new_channel_init) -> Optional[torch.Tensor]:
        """The (C, D) channel embeddings of ``split``'s channels under a
        leave-one-out strategy (``trainer.py:1231-1250``), or None for no
        strategy, ``as_is`` or a model without a table. ``random_input_corr``
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
        own row, a novel channel's :func:`dynamic_input_corr` row."""
        variant = int(str(strategy)[-1])
        training_channels = self._training_channels()
        ce = self._channel_embed()
        proj_fn = None
        if variant in (5, 6):
            fe = self.model.feature_extractor
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
