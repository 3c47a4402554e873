"""CLI entry point of the port (counterpart of the repository's ``main.py``):

    python -m diverse_channel_vit_torch.main -cn synthetic_cfg ++hardware.device=cpu ++train.debug=True
    python -m diverse_channel_vit_torch.main -cn jump_cp_cfg model=dichavit ++model.enable_sample=True

Group swaps (``model=dichavit``), key overrides (``train.batch_size=64``)
and force-adds (``++model.gamma_s=0.5``) behave like Hydra, over the port's
own config tree (``config/configs``). Training runs on the card
(``hardware.device: cuda``) unless ``++hardware.device=cpu`` asks for the
CPU. One process, one card: no distributed init (ROADMAP A10). Importing
this module parses nothing and starts nothing.

An f32 run (``++train.dtype=float32``, the reference's own precision) runs
its f32 products in full f32: ``main`` turns TF32 off for matmuls and cuDNN
for the run and restores both flags on return.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-cn", "--config-name", default="so2sat_city_cfg")
    parser.add_argument("-m", "--multirun", action="store_true", help="accepted for CLI parity")
    parser.add_argument("overrides", nargs="*", help="Hydra-style key=value overrides")
    return parser.parse_args(argv)


def main(argv=None) -> float:
    """Compose the config, build the Trainer, train; returns the best eval
    accuracy."""
    import contextlib

    import torch

    from .config import load_config
    from .device import tf32_off
    from .trainer import Trainer, compute_dtype

    args = parse_args(argv if argv is not None else sys.argv[1:])
    cfg = load_config(args.config_name, args.overrides)
    f32 = compute_dtype(cfg) == torch.float32
    with tf32_off() if f32 else contextlib.nullcontext():
        trainer = Trainer(cfg)
        trainer.logger.log_config(cfg)
        return trainer.train()


if __name__ == "__main__":
    main()
