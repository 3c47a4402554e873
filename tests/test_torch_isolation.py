"""The port and chip_smoke.py import neither JAX nor the JAX package.

In a fresh interpreter with ``jax``, ``flax`` and ``optax`` set to None in
``sys.modules`` (so importing any of them fails), every module of
``diverse_channel_vit_torch`` (``training/`` included) and ``chip_smoke``
must import (the benchmark scripts of ``scripts/`` and ``bench`` too, the
training entry point: ``main``, ``trainer``, the data layer, and CHAMMI's
modules: ``data/morphem70k``, ``data/tps``, ``native``, ``evaluation/*``, the
novel-channel synthesis, ``ops/novel_channels``, and the Trainer's runtime:
``training/freeze``, ``training/miro``, ``training/preemption``,
``models/import_torch``, the ResNet-34 channel scorer,
``models/resnet``, and the baselines' modules: ``models/trunk``,
``models/vit_adapt``, ``models/channel_attention_pooling``,
``models/depthwise_vit``, ``models/hypernet``, ``models/hyper_vit``,
``models/template_mixing_vit``, ``data/cifar`` and
``scripts/make_cifar_fixture``, and the ConvNeXt family, DINOv2 and the
feature-extraction CLI: ``models/convnext``, ``models/convnext_variants``,
``models/dinov2``, ``evaluation/feature_extraction``), and no
``diverse_channel_vit_tpu`` module may appear in ``sys.modules``. Importing
``main`` parses no command line: the probe's argv holds an option that
``main``'s parser would refuse.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
sys.argv = ["probe", "--no-such-option"]
import diverse_channel_vit_torch
names = [m.name for m in pkgutil.walk_packages(diverse_channel_vit_torch.__path__,
                                               "diverse_channel_vit_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.startswith(("diverse_channel_vit_tpu", "jax.", "flax.", "optax.")))
print(len(names), leaked)
assert not leaked, leaked
assert sys.modules["jax"] is None
assert "diverse_channel_vit_torch.training.steps" in sys.modules
assert "diverse_channel_vit_torch.ops.sampling" in sys.modules
assert "diverse_channel_vit_torch.scripts.bench_attn" in sys.modules
assert "diverse_channel_vit_torch.bench" in sys.modules
for name in ("main", "trainer", "data.loaders", "config.loader", "ops.augment",
             "training.checkpoint", "logging_utils", "utils.misc", "data.morphem70k",
             "data.tps", "native", "evaluation", "evaluation.knn", "evaluation.metrics",
             "evaluation.benchmark", "evaluation.morphem_eval", "ops.novel_channels",
             "training.freeze", "training.miro", "training.preemption",
             "models.import_torch", "models.resnet", "ops.token_pruning",
             "training.optim", "models.trunk", "models.vit_adapt",
             "models.channel_attention_pooling", "models.depthwise_vit", "models.hypernet",
             "models.hyper_vit", "models.template_mixing_vit", "data.cifar",
             "scripts.make_cifar_fixture", "models.convnext", "models.convnext_variants",
             "models.dinov2", "evaluation.feature_extraction"):
    assert "diverse_channel_vit_torch." + name in sys.modules, name
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 73, proc.stdout
