"""Adaptive mel-frame chunk scheduling for streaming synthesis.

Reproduces the load-bearing behavior of the reference's
``AdaptiveMelChunker`` (``crates/sonata/models/piper/src/lib.rs:860-913``):

- chunk ``i`` (1-based) spans ``chunk_size * i`` frames, capped at
  ``MAX_CHUNK_SIZE = 1024`` (``:18-19,888``) — small first chunk for fast
  time-to-first-byte, growing chunks for throughput;
- consecutive chunks overlap by ``2 * chunk_padding`` frames, with the
  padding trimmed from the emitted audio (``:891-906``);
- a tail shorter than ``MIN_CHUNK_SIZE = 44`` frames merges into the final
  chunk (``:900``);
- a one-shot path when the utterance fits ``2*chunk + 2*padding`` frames
  (``:785,846-853``);
- frame→sample indexing is ``× hop`` (256 in Piper voices, ``:910``).

Addition: each window is padded up to a power-of-two-ish bucket, so the
decoder sees a bounded set of shapes (the reference's ORT decoder takes any
shape).
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_CHUNK_SIZE = 1024  # frames (piper/src/lib.rs:18)
MIN_CHUNK_SIZE = 44    # frames (piper/src/lib.rs:19)
CROSSFADE_SAMPLES = 42  # per-chunk edge taper (piper/src/lib.rs:838)


@dataclass(frozen=True)
class ChunkPlan:
    """One decoder dispatch: decode frames [win_start, win_end), then trim
    ``trim_left``/``trim_right`` frames' worth of samples from the edges."""

    win_start: int
    win_end: int
    trim_left: int
    trim_right: int

    @property
    def width(self) -> int:
        return self.win_end - self.win_start

    def sample_slice(self, hop: int) -> tuple[int, int]:
        """Slice into the decoded window's samples, post-trim."""
        return self.trim_left * hop, (self.win_end - self.win_start - self.trim_right) * hop


def plan_chunks(total_frames: int, chunk_size: int,
                chunk_padding: int) -> list[ChunkPlan]:
    """Compute the full chunk schedule for an utterance."""
    if total_frames <= 0:
        return []
    if total_frames <= 2 * chunk_size + 2 * chunk_padding:
        return [ChunkPlan(0, total_frames, 0, 0)]  # one-shot (:846-853)
    plans: list[ChunkPlan] = []
    start, step = 0, 1
    while start < total_frames:
        size = min(chunk_size * step, MAX_CHUNK_SIZE)
        end = min(start + size, total_frames)
        if total_frames - end < MIN_CHUNK_SIZE:
            end = total_frames  # merge short tail (:900)
        ws = max(start - chunk_padding, 0)
        we = min(end + chunk_padding, total_frames)
        plans.append(ChunkPlan(ws, we, start - ws, we - end))
        start = end
        step += 1
    return plans


