"""Logging multiplexer (counterpart of the JAX package's ``logging_utils.py``).

Counterpart of the reference's ``custom_log.py``: ``MyLogging`` (:131-250)
multiplexes metrics and messages to stdout or python logging, wandb and
TensorBoard with a dict-message protocol (dicts are metrics, strings are
messages); ``DummyLogger`` (:88-127) swallows everything. ``logging: no``
(the default of every top-level config) logs to stdout only.

The JAX package falls back to a local wandb-layout file when the wandb
package is missing. The port does not: a sink whose package is missing
raises ``ImportError`` when the logger is built, naming the package
(``wandb`` for ``logging=wandb``; ``tensorboard``, which
``torch.utils.tensorboard`` needs, for ``logging=tensorboard``).
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any, Dict, Optional, Union


class DummyLogger:
    """No-op logger (``custom_log.py:88-127``)."""

    def info(self, *a, **k):
        pass

    def log_config(self, *a, **k):
        pass

    def finish(self, *a, **k):
        pass


def _require(package: str, sink: str):
    try:
        return __import__(package)
    except ImportError as e:
        raise ImportError(f"{sink} needs the {package!r} package, which is not installed; "
                          "use logging=no") from e


class TensorBoardSink:
    """TensorBoard scalar sink through ``torch.utils.tensorboard``: numeric
    values of a dict message become scalars. The step axis is an explicit
    ``step``/``num_updates``/``epoch`` key when the message carries one,
    else a per-sink counter."""

    STEP_KEYS = ("step", "num_updates", "epoch")

    def __init__(self, logdir: str):
        _require("tensorboard", "logging.tensorboard")
        from torch.utils.tensorboard import SummaryWriter

        self.dir = logdir
        self.writer = SummaryWriter(logdir)
        self._step = 0

    def log(self, metrics: Dict[str, Any]):
        step = None
        for k in self.STEP_KEYS:
            v = metrics.get(k)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                step = int(v)
                break
        if step is None:
            step = self._step
        self._step = step + 1
        for k, v in metrics.items():
            if isinstance(v, bool) or k in self.STEP_KEYS:
                continue
            try:
                self.writer.add_scalar(k.replace(" ", "_"), float(v), step)
            except (TypeError, ValueError):
                continue  # non-scalar payloads (strings, arrays) are skipped
        self.writer.flush()

    def finish(self):
        self.writer.close()


class MyLogging:
    """stdout / python-logging / wandb / tensorboard metric multiplexer
    (``custom_log.py:131-250`` parity; dict messages log as metrics)."""

    def __init__(self, cfg, *, project_name: Optional[str] = None):
        self.cfg = cfg
        wandb_cfg = cfg.logging.get("wandb", {}) if hasattr(cfg, "logging") else {}
        self.use_wandb = bool(wandb_cfg.get("use_wandb", False))
        self.use_py_log = bool(cfg.logging.get("use_py_log", False)) if hasattr(cfg, "logging") else False
        self.wandb = None
        if self.use_wandb:
            self.wandb = _require("wandb", "logging.wandb.use_wandb")
            config = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
            self.wandb.init(project=project_name or wandb_cfg.get("project_name") or "dichavit",
                            name=wandb_cfg.get("run_name"), config=config)
        self.tb = None
        if hasattr(cfg, "logging") and bool(cfg.logging.get("tensorboard", False)):
            import datetime
            import os

            base = str(cfg.logging.get("tensorboard_dir", "tb_logs"))
            run = wandb_cfg.get("run_name") or (
                "run_" + datetime.datetime.now().strftime("%Y%m%d_%H%M%S"))
            self.tb = TensorBoardSink(os.path.join(base, str(run)))
            print(f"[logging] tensorboard scalars -> {self.tb.dir}")
        self.py_logger = None
        if self.use_py_log:
            self.py_logger = logging.getLogger("diverse_channel_vit_torch")
            if not self.py_logger.handlers:
                h = logging.StreamHandler(sys.stdout)
                h.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
                self.py_logger.addHandler(h)
                self.py_logger.setLevel(logging.INFO)

    def info(self, msg: Union[str, Dict[str, Any]], sep: str = ", ", pref_msg: str = ""):
        """Dict messages are metrics; strings are plain log lines
        (``custom_log.py:162-179``)."""
        if isinstance(msg, dict):
            if self.wandb is not None:
                self.wandb.log(msg)
            if self.tb is not None:
                self.tb.log(msg)
            line = pref_msg + " " + sep.join(f"{k}: {v}" for k, v in msg.items())
            self._emit(line.strip())
        else:
            self._emit(pref_msg + msg)

    def _emit(self, line: str):
        if self.py_logger is not None:
            self.py_logger.info(line)
        else:
            print(line, flush=True)

    def log_config(self, cfg):
        self._emit("config: " + json.dumps(cfg.to_dict() if hasattr(cfg, "to_dict")
                                           else dict(cfg), default=str))

    def finish(self, msg_str: str = ""):
        if msg_str:
            self._emit(msg_str)
        if self.wandb is not None:
            self.wandb.finish()
        if self.tb is not None:
            self.tb.finish()
