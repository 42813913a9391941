"""Input prediction strategies (the port's copy of ``ggrs_tpu/predict``):
the fork's pluggable ``InputPredictor`` (lib.rs:374-406) plus device-batched
prediction over every slot of a session pool.

Two tiers:

* **Scalar strategies** (``PredictRepeatLast``, ``PredictDefault``,
  ``PredictCustom``), defined in :mod:`ggrs_tpu_torch.core.config` because
  the native-eligibility gate dispatches on ``type(predictor)``; re-exported
  here so ``ggrs_tpu_torch.predict`` is the one stop for strategies.
* **Batched strategies** (:mod:`.batched`): a ``BatchedInputPredictor``
  carries a vectorized ``kernel(u8[B, P, S]) -> u8[B, P, S]`` predicting
  every slot's missing inputs in one device call, served to the per-slot
  input queues through a :class:`DevicePredictionPlane`.  The scalar
  ``predict`` on the same object is the semantic reference and the
  fallback, so confirmed streams are bit-identical with or without the
  device table.
"""

from ..core.config import (
    InputPredictor,
    PredictCustom,
    PredictDefault,
    PredictRepeatLast,
)
from .batched import (
    BatchedDefault,
    BatchedInputPredictor,
    BatchedRepeatLast,
    DevicePredictionPlane,
)

__all__ = [
    "BatchedDefault",
    "BatchedInputPredictor",
    "BatchedRepeatLast",
    "DevicePredictionPlane",
    "InputPredictor",
    "PredictCustom",
    "PredictDefault",
    "PredictRepeatLast",
]
