"""ChipVM: a tiny deterministic 8-bit virtual machine as a game state.

The port of ``ggrs_tpu/games/chipvm.py``.  State is 256 bytes of memory, 4
registers and a pc, all uint8, batched over sessions:
``{"mem": (B, 256), "regs": (B, 4), "pc": (B,)}``.  Inputs ``(B, P)`` uint8
are written into fixed memory cells each frame.  The interpreter is
branchless: every opcode's effect is computed and the result selected, and
every memory or register access is a one-hot compare plus a select or a max
over the last axis, so B divergent machines run in lockstep without a
gather or scatter.  uint8 arithmetic wraps in torch as in JAX.

Opcode format (2 bytes: op byte at pc, operand at pc+1):
  op = (kind << 4) | (a << 2) | b     kinds:
  0 NOP        1 LDI  r[a] = imm      2 ADD r[a] += r[b]
  3 XOR  r[a] ^= r[b]                 4 LD  r[a] = mem[imm]
  5 ST   mem[imm] = r[a]              6 JNZ pc = imm if r[a] != 0
  7 INP  r[a] = input[b mod P]        8+ treated as NOP
pc advances by 2 (wrapping) unless a JNZ takes.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..convert import from_numpy
from ..core.device import DeviceLike

MEM_SIZE = 256
NUM_REGS = 4
STEPS_PER_FRAME = 16
# inputs land here each frame, one byte per player (read with INP or LD)
INPUT_BASE = 0xF0


def _decode(op: int) -> Tuple[int, int, int]:
    return op >> 4, (op >> 2) & 0b11, op & 0b11


@functools.lru_cache(maxsize=8)
def _lanes(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(address lanes (1, 256), register lanes (1, 4)) int32 on ``device``."""
    return (
        torch.arange(MEM_SIZE, dtype=torch.int32, device=device).unsqueeze(0),
        torch.arange(NUM_REGS, dtype=torch.int32, device=device).unsqueeze(0),
    )


class ChipVM:
    """``init_state`` / batch-native ``advance`` in torch, and the NumPy
    oracle ``init_state_np`` / ``advance_np`` (one unbatched state)."""

    def __init__(self, num_players: int = 2, steps_per_frame: int = STEPS_PER_FRAME) -> None:
        if not 1 <= num_players <= 4:
            raise ValueError("ChipVM supports 1-4 players")
        self.num_players = num_players
        self.steps = steps_per_frame

    # -- state ---------------------------------------------------------

    def _program(self) -> np.ndarray:
        """A fixed demo ROM: mixes inputs into a rolling hash across memory.
        Deterministic constant -- part of the game definition."""
        rom = np.zeros(MEM_SIZE, np.uint8)
        code = [
            (7, 0, 0), (7, 1, 1),          # r0 = in[0], r1 = in[1]
            (2, 0, 1),                     # r0 += r1
            (4, 2, 0), (0x40,),            # r2 = mem[0x40]
            (3, 2, 0),                     # r2 ^= r0
            (2, 2, 2),                     # r2 += r2
            (5, 2, 0), (0x40,),            # mem[0x40] = r2
            (4, 3, 0), (0x41,),            # r3 = mem[0x41]
            (2, 3, 2),                     # r3 += r2
            (5, 3, 0), (0x41,),            # mem[0x41] = r3
            (6, 3, 0), (0x00,),            # jnz r3 -> 0
        ]
        pc = 0
        for entry in code:
            if len(entry) == 3:
                kind, a, b = entry
                rom[pc] = (kind << 4) | (a << 2) | b
                pc += 1
                if kind in (1, 4, 5, 6):
                    continue  # operand byte appended by next entry
                rom[pc] = 0
                pc += 1
            else:
                rom[pc] = entry[0]
                pc += 1
        return rom

    def init_state_np(self) -> Dict[str, np.ndarray]:
        return {
            "mem": self._program(),
            "regs": np.zeros(NUM_REGS, np.uint8),
            "pc": np.uint8(0),
        }

    def init_state(self, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """One unbatched initial state as tensors on ``device``."""
        return from_numpy(self.init_state_np(), device)

    # -- advance: torch, batch-native, branchless -------------------------

    def advance(self, state: Any, inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One frame = ``steps`` fetch/decode/execute cycles for B machines.
        ``inputs``: (B, P) uint8."""
        lane, rlane = _lanes(inputs.device)

        def fetch(mem: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
            # one-hot read: exact because exactly one lane matches
            return torch.amax(torch.where(lane == addr.unsqueeze(1), mem, 0), dim=1)

        mem = state["mem"].clone()
        # this frame's inputs go into the input cells (static indices)
        mem[:, INPUT_BASE:INPUT_BASE + self.num_players] = inputs
        regs, pc = state["regs"], state["pc"]
        for _ in range(self.steps):
            pc32 = pc.to(torch.int32)
            op = fetch(mem, pc32)
            imm = fetch(mem, (pc32 + 1) & 0xFF)
            imm32 = imm.to(torch.int32)
            kind = op >> 4
            a = ((op >> 2) & 0b11).to(torch.int32).unsqueeze(1)
            b = (op & 0b11).to(torch.int32)
            sel_a = rlane == a
            ra = torch.amax(torch.where(sel_a, regs, 0), dim=1)
            rb = torch.amax(torch.where(rlane == b.unsqueeze(1), regs, 0), dim=1)
            mem_imm = fetch(mem, imm32)
            inp = fetch(mem, INPUT_BASE + (b % self.num_players))

            new_ra = torch.where(
                kind == 1, imm,
                torch.where(kind == 2, ra + rb,
                torch.where(kind == 3, ra ^ rb,
                torch.where(kind == 4, mem_imm,
                torch.where(kind == 7, inp, ra)))),
            )
            regs = torch.where(sel_a, new_ra.unsqueeze(1), regs)

            # ST: one-hot store, masked to kind == 5
            store = (lane == imm32.unsqueeze(1)) & (kind == 5).unsqueeze(1)
            mem = torch.where(store, new_ra.unsqueeze(1), mem)

            seq = pc + 2  # uint8: wraps at 256, fixed 2-byte slots
            take = (kind == 6) & (new_ra != 0)
            pc = torch.where(take, imm, seq)
        return {"mem": mem, "regs": regs, "pc": pc}

    # -- advance: numpy oracle ------------------------------------------

    def advance_np(self, state: Dict[str, np.ndarray], inputs: np.ndarray) -> Dict[str, np.ndarray]:
        mem = state["mem"].copy()
        regs = state["regs"].copy()
        pc = int(state["pc"])
        for p in range(self.num_players):
            mem[INPUT_BASE + p] = np.uint8(inputs[p])
        for _ in range(self.steps):
            op = int(mem[pc])
            imm = int(mem[(pc + 1) % 256])
            kind, a, b = _decode(op)
            if kind == 1:
                regs[a] = imm
            elif kind == 2:
                regs[a] = np.uint8((int(regs[a]) + int(regs[b])) & 0xFF)
            elif kind == 3:
                regs[a] = regs[a] ^ regs[b]
            elif kind == 4:
                regs[a] = mem[imm]
            elif kind == 5:
                mem[imm] = regs[a]
            elif kind == 7:
                regs[a] = mem[INPUT_BASE + (b % self.num_players)]
            if kind == 6 and regs[a] != 0:
                pc = imm
            else:
                pc = (pc + 2) % 256
        return {"mem": mem, "regs": regs, "pc": np.uint8(pc)}
