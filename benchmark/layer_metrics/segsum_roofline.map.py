"""segsum_roofline.map: the fixed-order segment sum's share of its
roofline over one request's BA and pose-graph sums (roofline/segsum.py),
over the summed device time of `segsum_kernel` and
`segsum_short_kernel`."""


def read(trace):
    return trace.roofline_pct("segsum")
