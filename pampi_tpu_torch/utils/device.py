"""The device rule of every entry point: `device=` defaults to "cuda", and a
CUDA request without a usable GPU raises instead of running on the CPU.
The CPU is used only when the caller asks for it by name."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu on the command line) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: cuda or cpu")
    return dev


def visible_devices(device="cuda") -> list[torch.device]:
    """The devices a mesh of shards may use (the counterpart of
    `jax.devices()`): every visible card for a CUDA request, the one CPU
    for a CPU request."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
