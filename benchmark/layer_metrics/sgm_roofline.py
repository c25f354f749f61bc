"""K1's share of its roofline: 100 x the least time the card could take for
one K1 call at the configuration's shapes (benchmark/roofline) / K1's
device time a frame (its kernels, by name, in the traced sub-window)."""

from benchmark.roofline import peaks, sgm


def read(rec):
    times = [e - s for name, s, e in rec.device_events
             if any(k in name for k in sgm.KERNELS)]
    disparity = rec.module("disparity")
    if not times or rec.frames <= 0 or disparity is None:
        return None
    k1_s = sum(times) / 1e6 / rec.frames
    nbytes, ops = sgm.work(rec.height, rec.width, disparity.get("num_disparities", 256))
    return 100.0 * peaks.bound_s(nbytes, ops)[0] / k1_s
