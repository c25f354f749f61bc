"""The 9x7 census, csrc/census.cu, with its plain version.

Replaces no TPU kernel: the JAX package's ``census_transform``
(cartslam_tpu/ops/stereo.py:37) is 62 shifted compares of jnp ops.  Here
``census_pair(left, right)`` computes both images of a stereo pair and
``census_transform(gray)`` one image: on CUDA tensors in one launch, on CPU
tensors as the plain version, ops/stereo.census_transform, one image after
the other.  Each image (uint8 [H, W]) gives two int32 [H, W] words.  The
outputs are integers, so the kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import torch

from ..ops import stereo
from . import build

COUNTER = build.counter("census")
MAX_ROWS = 65535 * 16  # the grid's y axis, 16 rows a tile

Words = tuple[torch.Tensor, torch.Tensor]


def census_transform(gray: torch.Tensor) -> Words:
    """9x7 census of gray (uint8 [H, W]) -> two int32 words [H, W]."""
    return _census(gray)[0]


def census_pair(left: torch.Tensor, right: torch.Tensor) -> tuple[Words, Words]:
    """9x7 census of a stereo pair (uint8 [H, W] each, same shape and
    device) -> (left's two words, right's two words)."""
    return _census(left, right)


@build.on_its_card
def _census(*images: torch.Tensor) -> tuple[Words, ...]:
    first = images[0]
    for name, g in zip(("left", "right"), images):
        if g.dtype != torch.uint8:
            raise ValueError(f"census: {name} dtype {g.dtype}, expected torch.uint8")
        if g.dim() != 2 or g.numel() == 0:
            raise ValueError(f"census: {name} shape {tuple(g.shape)}, expected [H, W] with "
                             "H, W >= 1")
        if g.shape != first.shape or g.device != first.device:
            raise ValueError(f"census: the pair differs: {tuple(first.shape)} on "
                             f"{first.device} and {tuple(g.shape)} on {g.device}")
    if first.device.type == "cpu":
        COUNTER.plain_calls += 1
        return tuple(stereo.census_transform(g) for g in images)
    h, w = first.shape
    if h > MAX_ROWS:
        raise ValueError(f"census: {h} rows, at most {MAX_ROWS}")
    for name, g in zip(("left", "right"), images):
        build.expect(g, name, torch.uint8)
    out = torch.empty((len(images), 2, h, w), dtype=torch.int32, device=first.device)
    build.check(build.library().census(first.data_ptr(), images[-1].data_ptr(), out.data_ptr(),
                                       len(images), h, w, build.stream()), "census")
    COUNTER.launches += 1
    return tuple((o[0], o[1]) for o in out)
