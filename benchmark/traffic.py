"""The one generator of traffic: a mix's parameters in, a run's inputs out.

A traffic mix (``traffic/<name>.json``) holds:

- ``entry``: the session entry, ``entries/<entry>.py`` (``"batched"``: B
  sessions in ``BatchedSessions``; ``"single"``: one
  ``DeviceSyncTestSession``), which ``program.entry`` loads;
- ``sessions``: B;
- ``loop``: ``"closed"``, the next call starts when the last returned;
- ``ticks_per_call``: ticks a ``run_ticks`` call carries (1: a live host,
  whose frame F's inputs exist only at frame F);
- ``inputs``: the input process.  ``"uniform_bits"`` draws each player's
  u8 of each tick uniformly over its ``bits`` low bits (at most 8); a block of
  ``block_ticks`` ticks is drawn in set-up and tick t takes row
  ``t mod block_ticks``, so a tick's inputs cost the window a slice;
- ``trace_ticks``: ticks the traced run profiles after its window.

Every session starts from the game's start.  The same seed gives the same
inputs, which both the program and the reference take.  The generator
reads ``sessions``, ``loop``, ``ticks_per_call`` and ``inputs`` alone; the
whole mix goes to the entry untouched, so an entry reads keys of its own
there (a network's latency and loss, say).  Further keys (such as
``sessions_from``, the derivation of ``sessions``) are for the reader.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict

import numpy as np
import torch


class Traffic:
    def __init__(self, traffic: dict, config: dict, reference: ModuleType, seed: int) -> None:
        if traffic["loop"] != "closed":
            raise ValueError(f"loop {traffic['loop']!r}: only a closed loop is generated")
        proc = traffic["inputs"]
        if proc["process"] != "uniform_bits":
            raise ValueError(f"input process {proc['process']!r} is not known")
        self.sessions = int(traffic["sessions"])
        self.ticks_per_call = int(traffic["ticks_per_call"])
        self.block_ticks = int(proc["block_ticks"])
        if self.block_ticks % self.ticks_per_call:
            raise ValueError("block_ticks must be a multiple of ticks_per_call")
        self.players = reference.players(config)
        self.start = reference.init_state(config)
        bits = int(proc["bits"])
        if not 1 <= bits <= 8:
            raise ValueError(f"{bits} bits do not fit a u8 input")
        # (block_ticks, B, P) u8: the bytes of the generator's raw 64-bit
        # words (little-endian), their low ``bits`` kept
        shape = (self.block_ticks, self.sessions, self.players)
        n = int(np.prod(shape))
        gen = np.random.default_rng(np.random.SeedSequence(seed % 2**64)).bit_generator
        raw = gen.random_raw(-(-n // 8)).astype("<u8", copy=False).view(np.uint8)[:n]
        self.block = (raw & np.uint8((1 << bits) - 1)).reshape(shape)

    def start_numpy(self) -> Dict[str, np.ndarray]:
        """The start as the program takes it: int32 numpy leaves."""
        return {k: v.to(torch.int32).numpy() for k, v in self.start.items()}

    def call_inputs(self, call: int) -> np.ndarray:
        """Call ``call``'s inputs, (n, B, P) for n ticks a call: a view of
        the block, which the entry puts in its session's layout."""
        n = self.ticks_per_call
        at = (call * n) % self.block_ticks
        return self.block[at:at + n]

    def tick_inputs_on(self, device: torch.device):
        """``t -> (B, P)`` u8 tensor of tick t on ``device`` (the block sent
        there once), for the reference."""
        block = torch.from_numpy(self.block).to(device)
        return lambda t: block[t % self.block_ticks]
