"""The port and chip_smoke.py import neither JAX nor the JAX package.

In a fresh interpreter with ``jax``, ``flax`` and ``optax`` set to None in
``sys.modules`` (so importing any of them fails), every module of
``diverse_channel_vit_torch`` (``training/`` included) and ``chip_smoke``
must import (the benchmark scripts of ``scripts/`` and ``bench`` too), and
no ``diverse_channel_vit_tpu`` module may appear in ``sys.modules``.
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
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 33, proc.stdout
