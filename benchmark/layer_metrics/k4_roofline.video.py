"""k4_roofline.video: K4's share of its roofline over B - 1 pairs of
1,536 x 1,536 x 128 (roofline/k4.py), over the summed device time of
`knn2_split_kernel` and `knn2_merge_kernel`."""


def read(trace):
    return trace.roofline_pct("k4")
