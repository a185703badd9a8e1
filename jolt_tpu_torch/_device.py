"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    The default is the CUDA card.  Without one this raises instead of
    sliding to the CPU: a CPU run has to be asked for with device="cpu".
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jolt_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
