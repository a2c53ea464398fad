"""k1_roofline.object: K1's share of its roofline over the scene's and
the object's launches (roofline/k1.py), over the summed device time of
`blur_kernel`."""


def read(trace):
    return trace.roofline_pct("k1")
