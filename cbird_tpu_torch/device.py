"""Device choice for the port.

Library classes take an explicit ``device``; ``None`` resolves here.  The
default is CUDA.  A machine without CUDA raises instead of carrying on
quietly on the CPU, unless the user selects the CPU explicitly with
``CBIRD_TORCH_DEVICE=cpu`` (the CPU tests do).
"""

from __future__ import annotations

import contextlib
import os

import torch

ENV = "CBIRD_TORCH_DEVICE"


def resolve(device: str | torch.device | None = None) -> torch.device:
    """@return ``device``, or the one ``CBIRD_TORCH_DEVICE`` names
    (default ``cuda``); raises when CUDA is asked for and absent."""
    dev = torch.device(device if device is not None
                       else os.environ.get(ENV, "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA is not available; set {ENV}=cpu to run on the CPU")
    return dev


def one_device(what: str, *tensors) -> torch.device:
    """The one device of a kernel's operands (``None`` entries skipped).
    @raise ValueError when they lie on more than one device"""
    devs = {(t.device.type, getattr(t.device, "index", None)): t.device
            for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{what}: operands on different devices "
                         f"{sorted(str(d) for d in devs.values())}")
    return devs.popitem()[1]


def launch_on(device: torch.device):
    """Context of a kernel launch: ``device`` is the calling thread's
    current CUDA device inside it, so a C launcher that reads the current
    device (its SM count, its shared-memory attribute) reads the one its
    stream and operands belong to.  Anything but a CUDA ``torch.device``
    (a stand-in of the tests) takes no guard."""
    if not isinstance(device, torch.device) or device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def set_hash_numerics() -> None:
    """Full float32 for the hash matmuls: every DCT coefficient is compared
    against the mean, so TF32 rounding could flip hash bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
