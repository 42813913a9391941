"""Published peaks of the chips the benchmark runs on.

One NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit): 80 GB of HBM3
at 3.35 TB/s.  The card's name as ``torch.cuda.get_device_name()`` gives it
picks the row; an unknown card has no peak, and a roofline share of it is
not reported."""

from __future__ import annotations

from typing import Optional

HBM_BYTES_PER_S = {"H100": 3.35e12}


def hbm_bytes_per_s(kind: str) -> Optional[float]:
    for name, rate in HBM_BYTES_PER_S.items():
        if name in kind:
            return rate
    return None
