"""Kernel K1 (the fused SGM: census cost, 4 path sweeps, winner search with
the uniqueness test, subpixel fit and left-right check): its bytes and
operations from its shapes.

Bytes: the four int32 census words of each pixel read once (two per view),
the int16 disparity written once.  Operations per (pixel, disparity) cell:
the census cost (2 xor, 2 popcount, 1 add), 7 per path step (3 adds, 3 mins,
1 subtract) for 4 paths, 3 adds for the 4-path sum, and 6 for the winner
searches (keyed minimum, second minimum, right-view minimum).
"""

# The names K1's kernels have in a device trace.
KERNELS = ("sgm_hpaths_kernel", "sgm_vpaths_kernel", "sgm_wta_kernel")
OPS_PER_CELL = 5 + 4 * 7 + 3 + 6


def work(height: int, width: int, disparities: int) -> tuple[float, float]:
    """(bytes, operations) of one K1 call on a height x width pair."""
    nbytes = 4 * height * width * 4 + height * width * 2
    return float(nbytes), float(height * width * disparities * OPS_PER_CELL)
