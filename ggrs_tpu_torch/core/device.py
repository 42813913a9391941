"""Device resolution shared by every entry point of the port.

``device=None`` means the CUDA card.  When CUDA is absent that is an error,
never a silent move to the CPU: a caller who wants the CPU (the tests do)
says ``device="cpu"``."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ggrs_tpu_torch: CUDA is not available on this machine; pass "
            "device='cpu' to run the port on the CPU"
        )
    return dev
