"""GOP / coding structure: I, P and hierarchical B frames.

Counterpart of ``coolchic_tpu/video/codingstructure.py`` (plain Python, the
port's own copy). ``intra_period`` inter frames follow the intra frame of a
GOP; ``p_period`` sets the furthest P prediction (1 = low-delay P,
``intra_period`` = random access), with hierarchical B frames in between.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

FRAME_TYPES = ("I", "P", "B")


@dataclass
class Frame:
    """One frame of the coding structure; its type follows from its number
    of references (0: I, 1: P, 2: B)."""

    coding_order: int
    display_order: int
    depth: int = 0
    index_references: List[int] = field(default_factory=list)
    seq_name: str = ""
    frame_type: str = field(init=False)

    def __post_init__(self):
        if len(self.index_references) > 2:
            raise ValueError(f"a frame has at most 2 references, found {self.index_references}")
        self.frame_type = FRAME_TYPES[len(self.index_references)]


@dataclass
class CodingStructure:
    """Frame graph of one GOP."""

    intra_period: int
    p_period: int = 0
    seq_name: str = ""
    frames: List[Frame] = field(init=False)

    def __post_init__(self):
        self.frames = self.compute_gop(self.intra_period, self.p_period)

    def get_frame_depth_in_gop(self, idx_frame: int) -> int:
        """Depth of display index ``idx_frame`` within one chained GOP: 0 for
        the intra frame, 1 for the P frame, 2 and more for B frames by
        bisection level."""
        if idx_frame > self.p_period:
            raise ValueError(f"frame {idx_frame} is past the P period {self.p_period}")
        if math.log2(self.p_period) % 1 != 0:
            raise ValueError(f"p_period should be a power of 2, found {self.p_period}")
        if idx_frame == 0:
            return 0
        depth = int(math.log2(self.p_period) + 1)
        for i in range(int(math.log2(self.p_period)), 0, -1):
            if idx_frame % 2**i == 0:
                depth = int(math.log2(self.p_period) - i + 1)
                break
        return depth

    def compute_gop(self, intra_period: int, p_period: int) -> List[Frame]:
        frames = [Frame(coding_order=0, display_order=0, index_references=[],
                        seq_name=self.seq_name)]
        if intra_period == 0 and p_period == 0:
            return frames
        if intra_period % p_period != 0:
            raise ValueError(
                f"Intra period must be divisible by P period. Found "
                f"intra_period = {intra_period}; p_period = {p_period}.")

        for index_chained_gop in range(intra_period // p_period):
            for index_frame_in_gop in range(1, p_period + 1):
                display_order = index_frame_in_gop + index_chained_gop * p_period
                depth = self.get_frame_depth_in_gop(index_frame_in_gop)
                delta_time_ref = p_period // 2 ** (depth - 1)
                if index_frame_in_gop == p_period:  # P frame
                    refs = [display_order - delta_time_ref]
                else:  # B frame
                    refs = [display_order - delta_time_ref, display_order + delta_time_ref]

                coding_order_in_gop = 0
                if depth != 0:
                    coding_order_in_gop = depth + sum(2 ** (x - 2) - 1 for x in range(3, depth))
                    coding_order_in_gop += (index_frame_in_gop - delta_time_ref) // (
                        2 * delta_time_ref)
                frames.append(Frame(
                    coding_order=index_chained_gop * p_period + coding_order_in_gop,
                    display_order=display_order,
                    index_references=refs,
                    depth=depth,
                    seq_name=self.seq_name,
                ))
        return frames

    def get_number_of_frames(self) -> int:
        return len(self.frames)

    def get_max_depth(self) -> int:
        return max(f.depth for f in self.frames)

    def get_frame_from_coding_order(self, coding_order: int) -> Optional[Frame]:
        return next((f for f in self.frames if f.coding_order == coding_order), None)

    def get_frame_from_display_order(self, display_order: int) -> Optional[Frame]:
        return next((f for f in self.frames if f.display_order == display_order), None)


def lmbda_from_depth(depth: int, initial_lmbda: float) -> float:
    """Rate weight of a frame at GOP depth ``depth``: lambda * 1.5^depth."""
    return initial_lmbda * (1.5**depth)
