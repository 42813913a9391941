"""The rollback replay: load -> (advance, digest, save)^d -> advance, per tick,
for a batch of sessions in lockstep.

This is the port of ``ggrs_tpu/ops/replay.py``: the request list a SyncTest
session emits per tick (Load, then ``check_distance`` resimulated
Save/Advance pairs, then the live Save/Advance;
GGRS src/sessions/sync_test_session.rs:85-150) run on device with
state, inputs and digests resident there.  A first-seen digest history is
compared with every resimulated frame's digest, so desyncs are counted on
device and reach the host only when asked.

Where the JAX package jits a ``lax.scan`` over ticks and donates the carry,
the port runs the ticks eagerly and updates the carry's preallocated tensors
IN PLACE (nothing is returned that the caller did not pass in).  The carry is
batched over sessions; its layout is the JAX package's with a leading
session axis, as ``BatchedSessions`` stacks it::

    ring       -- DeviceStateRing buffers (states / checksums / frames)
    inputs     -- input ring (B, R, ...), same slotting as the state ring
    hist       -- (B, R, 4) int32 first-seen digest per frame slot
    live       -- the current (unsaved) game state, leaves (B, ...)
    frame      -- (B,) int32, the sessions' current frame (bookkeeping)
    mismatches -- (B,) int32 count of resimulated frames whose digest diverged
    first_bad  -- (B,) int32 earliest mismatched frame (INT32_MAX if none)

Digests are int32 tensors holding u32 bit patterns.  Frames are host ints
(sessions tick in lockstep), so every ring access is a shared-index slice.
``run_*`` never reads a value back to the host and never synchronises.

The d resimulated states are digested together: the stacked ``(B, d, ...)``
window that ``save_many`` writes is digested as B*d rows in ONE
``checksum`` call (one kernel launch on the card), where the JAX scan digests
each step inside its body.  Every digest is per row, so the values are
bitwise the same.  A tick, warmup or steady, makes two digest calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..convert import from_numpy
from ..core.device import DeviceLike, resolve_device
from ..utils.tracing import trace_span
from ..utils.tree import tree_leaves, tree_map
from .checksum import CHECKSUM_LANES, checksum_device
from .ring import DeviceStateRing

I32_MAX = 2**31 - 1

AdvanceFn = Callable[[Any, Any], Any]  # (states (B, ...), inputs (B, ...)) -> states
ChecksumFn = Callable[[Any], torch.Tensor]  # states (B, ...) -> (B, 4) int32


def _copy_into(dst: Any, src: Any) -> None:
    tree_map(lambda d, s: d.copy_(s), dst, src)


def _tick_slice(tick_inputs: Any, t: int) -> Any:
    return tree_map(lambda a: a[:, t], tick_inputs)


@dataclass(frozen=True)
class ReplayPrograms:
    """Tick programs over a fixed (advance, ring, check_distance).

    ``advance`` is batch-native and pure: it takes state leaves ``(B, ...)``
    and inputs ``(B, ...)`` and returns new tensors without writing its
    arguments (the loaded state is a view of the ring)."""

    ring: DeviceStateRing
    check_distance: int
    advance: AdvanceFn
    checksum: ChecksumFn

    @property
    def warmup_ticks(self) -> int:
        """Ticks before rollback starts: frames 0..d inclusive (the reference
        only rolls back once current_frame > check_distance)."""
        return self.check_distance + 1

    def split_at_warmup(self, ticks_run: int, n: int) -> int:
        """How many of the next ``n`` ticks must go through the warmup program
        given ``ticks_run`` ticks already executed."""
        return min(max(0, self.warmup_ticks - ticks_run), n)

    # -- carry ---------------------------------------------------------

    def init_carry(
        self,
        init_state: Any,
        input_template: Any,
        batch_size: int = 1,
        device: DeviceLike = None,
    ) -> Any:
        """Carry for ``batch_size`` sessions starting at frame 0, each with
        (a copy of) ``init_state``.  ``init_state`` and ``input_template``
        (one frame's inputs, e.g. a (P,) u8 array) are unbatched numpy arrays
        or tensors."""
        dev = resolve_device(device)
        b, r = batch_size, self.ring.length

        def batched(leaf: torch.Tensor) -> torch.Tensor:
            return leaf.unsqueeze(0).expand(b, *leaf.shape).clone()

        live = tree_map(batched, from_numpy(init_state, dev))
        inputs = tree_map(
            lambda leaf: torch.zeros((b, r, *leaf.shape), dtype=leaf.dtype, device=dev),
            from_numpy(input_template, dev),
        )
        return {
            "ring": self.ring.init(live),
            "inputs": inputs,
            "hist": torch.zeros((b, r, CHECKSUM_LANES), dtype=torch.int32, device=dev),
            "live": live,
            "frame": torch.zeros((b,), dtype=torch.int32, device=dev),
            "mismatches": torch.zeros((b,), dtype=torch.int32, device=dev),
            "first_bad": torch.full((b,), I32_MAX, dtype=torch.int32, device=dev),
        }

    # -- ticks ---------------------------------------------------------

    def _store_input(self, carry: Any, frame: int, inp: Any) -> None:
        i = self.ring.slot(frame)
        tree_map(lambda buf, leaf: buf[:, i].copy_(leaf), carry["inputs"], inp)

    def warmup_tick(self, carry: Any, inp: Any, frame: int) -> None:
        """[Save, Advance] -- the pre-rollback request pattern."""
        ring, hist = self.ring, carry["hist"]
        live = carry["live"]
        cs = self.checksum(live)
        ring.save(carry["ring"], frame, live, cs)
        hist[:, ring.slot(frame)] = cs
        self._store_input(carry, frame, inp)
        new_live = self.advance(live, inp)
        # first-seen digest for frame+1 comes from this live advance; later
        # resimulations of that frame are compared against it
        hist[:, ring.slot(frame + 1)] = self.checksum(new_live)
        _copy_into(live, new_live)

    def steady_tick(self, carry: Any, inp: Any, frame: int) -> None:
        """[Load, (Save, Advance) x d resim, Save, Advance] -- 2d+2 requests."""
        ring, d = self.ring, self.check_distance
        self._store_input(carry, frame, inp)
        st = ring.load(carry["ring"], frame - d)
        # the window's d inputs, gathered once (at most two slices per leaf)
        window_inputs = tree_map(
            lambda buf: ring.read_window(buf, frame - d, d), carry["inputs"]
        )
        states = []
        for j in range(d):
            st = self.advance(st, _tick_slice(window_inputs, j))
            states.append(st)
        # the window F-d+1 .. F: one digest call over its B*d rows (a view of
        # the stack), one save_many
        first = frame - d + 1
        window = tree_map(lambda *leaves: torch.stack(leaves, dim=1), *states)
        rows = self.checksum(tree_map(lambda leaf: leaf.flatten(0, 1), window))
        resim_cs = rows.reshape(-1, d, CHECKSUM_LANES)  # (B, d, 4)
        ring.save_many(carry["ring"], first, window, resim_cs)
        # every window frame has a first-seen digest (frame F's was recorded
        # by the previous tick's live advance), so the whole window is checked
        seen = ring.read_window(carry["hist"], first, d)
        bad = (resim_cs != seen).any(dim=2)  # (B, d)
        carry["mismatches"].add_(bad.sum(dim=1, dtype=torch.int32))
        frames = torch.arange(first, frame + 1, dtype=torch.int32, device=bad.device)
        worst = torch.where(bad, frames, I32_MAX).amin(dim=1)
        torch.minimum(carry["first_bad"], worst, out=carry["first_bad"])
        new_live = self.advance(st, inp)  # st is the resimulated state at F
        carry["hist"][:, ring.slot(frame + 1)] = self.checksum(new_live)
        _copy_into(carry["live"], new_live)

    def _run(self, tick: Callable, carry: Any, tick_inputs: Any, start_frame: int) -> Any:
        """``tick`` over the ticks axis (axis 1) of ``tick_inputs``, leaves
        ``(B, n, ...)``; tick ``t`` runs frame ``start_frame + t``."""
        n = tree_leaves(tick_inputs)[0].shape[1]
        for t in range(n):
            tick(carry, _tick_slice(tick_inputs, t), start_frame + t)
        carry["frame"].add_(n)
        return carry

    def run_warmup(self, carry: Any, tick_inputs: Any, start_frame: int) -> Any:
        with trace_span("ggrs:replay_warmup"):
            return self._run(self.warmup_tick, carry, tick_inputs, start_frame)

    def run_steady(self, carry: Any, tick_inputs: Any, start_frame: int) -> Any:
        with trace_span("ggrs:replay_steady"):
            return self._run(self.steady_tick, carry, tick_inputs, start_frame)


def build_scrub_program(advance: AdvanceFn, device: DeviceLike = None) -> Callable[[Any, Any], Any]:
    """The confirmed-only playback program: advance N frames with state and
    inputs resident on ``device`` -- the fast-forward mode of journal replay
    (``sessions.replay.ReplaySession``).

    Replaying a journal never rolls back (every input is confirmed), so the
    tick above collapses to a bare run of advances: no ring, no digest
    history, no resimulation.  The returned callable is
    ``scrub(state, stacked_inputs) -> state`` for one unbatched state, with
    the window's per-frame inputs stacked on the leading axis.  The window is
    uploaded once; the batch-native ``advance`` runs eagerly on ``(1, ...)``
    views, each frame on the previous frame's output, and nothing is read
    back.  The argument state is never written (the JAX package donates it
    on a TPU only)."""
    dev = resolve_device(device)

    def scrub(state: Any, stacked_inputs: Any) -> Any:
        inputs = from_numpy(stacked_inputs, dev)
        st = tree_map(lambda leaf: leaf.unsqueeze(0), from_numpy(state, dev))
        with trace_span("ggrs:scrub"):
            for k in range(tree_leaves(inputs)[0].shape[0]):
                st = advance(st, tree_map(lambda leaf: leaf[k:k + 1], inputs))
        return tree_map(lambda leaf: leaf[0], st)

    return scrub


def build_replay_programs(
    advance: AdvanceFn,
    ring_length: int,
    check_distance: int,
    checksum: ChecksumFn = checksum_device,
) -> ReplayPrograms:
    """Tick programs for a batch-native ``advance``.  ``ring_length`` must
    exceed ``check_distance`` so the rollback target is still in the ring,
    mirroring ``max_prediction + 1`` cells in the reference."""
    if check_distance < 1:
        raise ValueError("device replay needs check_distance >= 1")
    if ring_length <= check_distance:
        raise ValueError("ring must cover the rollback window")
    return ReplayPrograms(
        ring=DeviceStateRing(ring_length),
        check_distance=check_distance,
        advance=advance,
        checksum=checksum,
    )
