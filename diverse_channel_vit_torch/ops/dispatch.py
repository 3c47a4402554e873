"""The kernel wrappers' shared dispatch: launch counts and the route switch.

Every kernel wrapper of the port (``ops/fused_block.py``,
``ops/attention.py``, and the benchmark scripts' ``scripts/bench_*.py``)
follows one rule: a CPU tensor takes the kernel's plain
PyTorch version; a CUDA tensor launches the kernel or raises, and never falls
back. :func:`plain_versions` routes CUDA tensors to the plain versions on
explicit request, for holding a kernel against its plain version on the card.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# launches of each kernel since the last reset_launches(); a wrapper counts
# where it launches its kernel and nowhere else (a backward counts one per
# call, however many CUDA launches it takes)
LAUNCHES = {"attend_project_fwd": 0, "ln_mlp_fwd": 0, "attend_project_bwd": 0, "ln_mlp_bwd": 0,
            "flash_packed_fwd": 0, "flash_packed_bwd": 0, "ln_mlp_q_fwd": 0, "ln_mlp_q_bwd": 0,
            # B5 and B6 on f32 tensors (their f32 kernels)
            "flash_packed_fwd_f32": 0, "flash_packed_bwd_f32": 0,
            # the benchmark scripts' kernels (diverse_channel_vit_torch/scripts/)
            "bwd_call": 0, "qkv_flash_fwd": 0, "int8_ln_mlp": 0}

_ROUTE = threading.local()  # .plain: CUDA tensors take the plain versions


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def _route(plain: bool):
    prev = getattr(_ROUTE, "plain", False)
    _ROUTE.plain = plain
    try:
        yield
    finally:
        _ROUTE.plain = prev


def plain_versions():
    """Run CUDA tensors through the plain versions inside this block, in the
    calling thread only (a comparison aid; the model's paths never enter it).
    A backward takes the route its forward took, though autograd runs it on
    a thread of its own."""
    return _route(True)


def current_route_plain() -> bool:
    """Whether :func:`plain_versions` is active in this thread (an autograd
    Function records it in its forward for its backward)."""
    return getattr(_ROUTE, "plain", False)


def _launches_kernel(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return not current_route_plain()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device: torch.device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} tensor of shape {tuple(shape)} on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)
