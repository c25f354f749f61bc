"""Color conversions with OpenCV semantics (counterpart of ops/color.py).

Images are BGR uint8 [H, W, 3] throughout, as cv::imread lays them out.
"""

import torch

# OpenCV ITU-R BT.601 luma weights (B, G, R order).
_B_W = 0.114
_G_W = 0.587
_R_W = 0.299

# OpenCV YCrCb constants for 8-bit images.
_CR_W = 0.713
_CB_W = 0.564
_DELTA = 128.0


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """BGR uint8 [H,W,3] -> gray uint8 [H,W] (cv::COLOR_BGR2GRAY)."""
    f = img.to(torch.float32)
    y = f[..., 0] * _B_W + f[..., 1] * _G_W + f[..., 2] * _R_W
    return _to_u8(y)


def bgr_to_ycrcb(img: torch.Tensor) -> torch.Tensor:
    """BGR uint8 [H,W,3] -> YCrCb uint8 [H,W,3] (cv::COLOR_BGR2YCrCb)."""
    f = img.to(torch.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y = b * _B_W + g * _G_W + r * _R_W
    cr = (r - y) * _CR_W + _DELTA
    cb = (b - y) * _CB_W + _DELTA
    return _to_u8(torch.stack([y, cr, cb], dim=-1))


def gray_to_bgr(img: torch.Tensor) -> torch.Tensor:
    """Gray uint8 [H,W] -> BGR uint8 [H,W,3]."""
    return img[..., None].expand(*img.shape, 3).contiguous()
