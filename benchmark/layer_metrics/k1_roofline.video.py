"""k1_roofline.video: K1-batch's share of its roofline: the least time
of every K1 launch of the profiled requests (roofline/k1.py) over the
summed device time of `blur_kernel`."""


def read(trace):
    return trace.roofline_pct("k1")
