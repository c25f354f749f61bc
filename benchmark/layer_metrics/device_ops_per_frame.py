"""Device operations (kernels, copies, memsets) a frame in the traced
sub-window: what one replay of the captured step launches, with the
frame's copies in and out."""


def read(rec):
    if not rec.device_events or rec.frames <= 0:
        return None
    return len(rec.device_events) / rec.frames
