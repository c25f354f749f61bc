"""The table of checks that a reference module gives, and the default count.

A reference module (named by a configuration's ``reference`` key) lists in
``CHECKS`` one ``Check`` for each output it compares.  ``benchmark/compare.py``
runs them: each check counts, over every delivered round, the elements of
its output on which the program and the reference disagree, and the run is
correct where every count is at most its limit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

_INT_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bits(x: torch.Tensor) -> torch.Tensor:
    """`x` as integers of its element size: its bit patterns, so that NaN,
    inf and -0.0 compare exactly."""
    return x.view(_INT_OF_SIZE[x.element_size()]) if x.is_floating_point() else x


def bits_differ(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Elements whose bit patterns differ (int64 scalar tensor); a shape or
    a dtype that differs counts every element of `want`."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return torch.tensor(want.numel(), dtype=torch.int64, device=want.device)
    return (bits(got) != bits(want)).sum()


@dataclasses.dataclass(frozen=True)
class Check:
    """One comparison of an output.

    key:    the output key the program fetches, or "<key>/<leaf>" for one
            leaf of an output that is a dict of arrays; a whole key covers
            all its leaves, compared leaf by leaf.
    name:   the number's name on the check lines.
    counts: what the number counts, in words.
    limit:  the largest count of a correct run.
    why:    the reason for a limit that is not 0.
    diff:   diff(got, want) -> int64 scalar tensor: the disagreements between
            two stacked [k, B, ...] tensors of one leaf, on one device.
    kept:   "every": every delivered round's copy is held until the
            reference runs; "first": the output depends on the stereo frame
            alone, so the first delivered copy of each frame-cycle position
            is held, and every later delivery of the position is compared
            with it byte for byte as it comes and then dropped (one that
            differs adds its count of differing elements to the check).
    always: compared in every run whose chain produces it, fetched or not
            by the traffic (an input of the host step, which the System
            fetches whatever the traffic asks for).
    """

    key: str
    name: str
    counts: str
    limit: int = 0
    why: str = ""
    diff: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = bits_differ
    kept: str = "every"
    always: bool = False

    @property
    def output(self) -> str:
        """The fetched key the check reads."""
        return self.key.split("/")[0]

    def covers(self, leaf: str) -> bool:
        return leaf == self.key or leaf.startswith(self.key + "/")
