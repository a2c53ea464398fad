"""Faithful NumPy twin of the reference CPU SIFT (canhld94/SIFT-GPU):
the benchmark's witness of its own plain reference (sift_plain.py).

A frozen copy, made at commit e1604af, of the port's
sift_tpu_torch/oracle/cpu_sift.py; only the config import differs
(sift_plain.RefConfig, the same fields). It runs on the host only, in
NumPy, and shares no code with sift_plain.py (its parameter block
aside) or with the port: the CPU tests
(benchmark/tests/test_bench_witness.py) hold the frozen reference to it.
Every function cites the reference behavior it mirrors (paths relative
to the reference checkout).
Deliberately preserved quirks:

  * Gaussian kernel truncated at radius floor(3*sigma), NOT
    renormalized (src/sift.cpp:95-108).
  * Blur reads the image's last row/col as zero — getSubMatrix treats
    index >= dim-1 as out of bounds (src/sift.cpp:116).
  * Per-scale blur runs from the octave *base*, sigmas
    sqrt((k^i s)^2 - s^2) (src/sift.cpp:240-258).
  * Octave downsample = INTER_NEAREST 2x decimation of layer
    `nOctaveLayers` of the previous octave (src/sift.cpp:252-254).
  * No initial 2x upsampling (src/sift.cpp:219-227), firstOctave = 0.
  * Extrema threshold is the literal 8 (src/sift.cpp:564).
  * Descriptor ends with a RootSIFT-style sqrt(L1) tail
    (src/sift.cpp:711-721); matching is L1 with ratio 0.86
    (src/main.cpp:25,38).

Not intended to be fast; tests run it on small images.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from benchmark.reference.sift_plain import RefConfig as SIFTConfig

DEFAULT_CONFIG = SIFTConfig()

FLT_EPSILON = np.float32(1.1920929e-07)

# OpenCV fastAtan2 polynomial coefficients (degrees). The reference
# computes orientations with cv::hal::fastAtan2 (src/sift.cpp:425,632),
# which uses this 7th-order polynomial approximation — we reproduce it
# exactly so bin assignments match.
_ATAN2_P1 = 0.9997878412794807 * (180.0 / math.pi)
_ATAN2_P3 = -0.3258083974640975 * (180.0 / math.pi)
_ATAN2_P5 = 0.1555786518463281 * (180.0 / math.pi)
_ATAN2_P7 = -0.04432655554792128 * (180.0 / math.pi)
_DBL_EPS = 2.220446049250313e-16


def fast_atan2_deg(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """OpenCV cv::hal::fastAtan2 twin: degrees in [0, 360)."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    ax, ay = np.abs(x), np.abs(y)
    swap = ax < ay
    c = np.where(swap, ax / (ay + _DBL_EPS), ay / (ax + _DBL_EPS)).astype(np.float32)
    c2 = c * c
    a = (((_ATAN2_P7 * c2 + _ATAN2_P5) * c2 + _ATAN2_P3) * c2 + _ATAN2_P1) * c
    a = np.where(swap, 90.0 - a, a)
    a = np.where(x < 0, 180.0 - a, a)
    a = np.where(y < 0, 360.0 - a, a)
    return a.astype(np.float32)


def cv_round(x) -> np.ndarray:
    """cvRound twin: round half to even (SSE cvtss2si semantics)."""
    return np.rint(x).astype(np.int64)


def gaussian_kernel_2d(sigma: float) -> np.ndarray:
    """2-D truncated, unnormalized Gaussian (src/sift.cpp:95-108).

    Coefficients are computed in double, scaled by 8192, stored float32;
    the conv divides the dot product by 8192 (src/sift.cpp:104,146).
    Net effect = float32 analytic Gaussian, truncated, unnormalized.
    """
    w = int(math.floor(3 * sigma))
    size = 2 * w + 1
    i = np.arange(-w, w + 1, dtype=np.float64)
    g2 = (1.0 / (2 * math.pi * sigma * sigma)
          * np.exp(-(i[:, None] ** 2 + i[None, :] ** 2) / (2 * sigma * sigma)))
    return (g2 * 8192.0).astype(np.float32) / np.float32(8192.0)


def gaussian_blur(src: np.ndarray, sigma: float) -> np.ndarray:
    """2-D convolution twin of Gaussian_Blur (src/sift.cpp:123-153).

    Zero padding, with the getSubMatrix off-by-one: any read at
    row >= rows-1 or col >= cols-1 yields 0 (src/sift.cpp:116), i.e.
    the true last row/col are treated as zeros.
    """
    from scipy import ndimage

    k = gaussian_kernel_2d(sigma)
    img = np.asarray(src, np.float32).copy()
    img[-1, :] = 0.0
    img[:, -1] = 0.0
    out = ndimage.correlate(img.astype(np.float64), k.astype(np.float64),
                            mode="constant", cval=0.0)
    return out.astype(np.float32)


def downsample_nearest_2x(src: np.ndarray) -> np.ndarray:
    """cv::resize INTER_NEAREST to (cols/2, rows/2) (src/sift.cpp:254).

    OpenCV nearest maps dst(x) -> src(floor(x * 2)), i.e. even rows/cols.
    """
    h2, w2 = src.shape[0] // 2, src.shape[1] // 2
    return src[0:2 * h2:2, 0:2 * w2:2]


def build_gaussian_pyramid(img: np.ndarray,
                           cfg: SIFTConfig = DEFAULT_CONFIG) -> List[np.ndarray]:
    """Twin of buildGaussianPyramid (src/sift.cpp:229-263).

    Returns a flat list of n_octaves * n_scales images, indexed
    [o * n_scales + i] (we use the *read* stride of the reference;
    its write stride o*nOctaves+i coincides because 5==5).
    """
    S = cfg.n_scales
    sig = cfg.scale_sigmas()
    gpyr: List[np.ndarray] = [None] * (cfg.n_octaves * S)
    base = gaussian_blur(np.asarray(img, np.float32), cfg.init_blur_sigma)
    for o in range(cfg.n_octaves):
        for i in range(S):
            if o == 0 and i == 0:
                gpyr[0] = base
            elif i == 0:
                gpyr[o * S] = downsample_nearest_2x(
                    gpyr[(o - 1) * S + cfg.n_octave_layers])
            else:
                gpyr[o * S + i] = gaussian_blur(gpyr[o * S], sig[i])
    return gpyr


def build_dog_pyramid(gpyr: List[np.ndarray],
                      cfg: SIFTConfig = DEFAULT_CONFIG) -> List[np.ndarray]:
    """Twin of buildDoGPyramid: dog = next - cur (src/sift.cpp:265-283)."""
    S = cfg.n_scales
    dog: List[np.ndarray] = []
    for o in range(cfg.n_octaves):
        for i in range(S - 1):
            dog.append(gpyr[o * S + i + 1] - gpyr[o * S + i])
    return dog


def _adjust_local_extrema(dog: List[np.ndarray], octv: int, layer: int,
                          r: int, c: int, cfg: SIFTConfig):
    """Twin of adjustLocalExtrema (src/sift.cpp:287-388).

    Returns None on rejection, else a keypoint dict.
    """
    img_scale = 1.0 / 255.0
    deriv_scale = img_scale * 0.5
    second_deriv_scale = img_scale
    cross_deriv_scale = img_scale * 0.25
    nL = cfg.n_octave_layers
    border = cfg.img_border

    xi = xr = xc = 0.0
    i = 0
    for i in range(cfg.max_interp_steps):
        idx = octv * (nL + 2) + layer
        img, prev, nxt = dog[idx], dog[idx - 1], dog[idx + 1]
        dD = np.array([
            (img[r, c + 1] - img[r, c - 1]) * deriv_scale,
            (img[r + 1, c] - img[r - 1, c]) * deriv_scale,
            (nxt[r, c] - prev[r, c]) * deriv_scale,
        ], np.float64)
        v2 = float(img[r, c]) * 2.0
        dxx = (img[r, c + 1] + img[r, c - 1] - v2) * second_deriv_scale
        dyy = (img[r + 1, c] + img[r - 1, c] - v2) * second_deriv_scale
        dss = (nxt[r, c] + prev[r, c] - v2) * second_deriv_scale
        dxy = (img[r + 1, c + 1] - img[r + 1, c - 1]
               - img[r - 1, c + 1] + img[r - 1, c - 1]) * cross_deriv_scale
        dxs = (nxt[r, c + 1] - nxt[r, c - 1]
               - prev[r, c + 1] + prev[r, c - 1]) * cross_deriv_scale
        dys = (nxt[r + 1, c] - nxt[r - 1, c]
               - prev[r + 1, c] + prev[r - 1, c]) * cross_deriv_scale
        H = np.array([[dxx, dxy, dxs],
                      [dxy, dyy, dys],
                      [dxs, dys, dss]], np.float64)
        try:
            X = np.linalg.solve(H, dD)
        except np.linalg.LinAlgError:
            return None
        xi, xr, xc = -X[2], -X[1], -X[0]
        if abs(xi) < 0.5 and abs(xr) < 0.5 and abs(xc) < 0.5:
            break
        if (abs(xi) > 2 ** 31 / 3 or abs(xr) > 2 ** 31 / 3
                or abs(xc) > 2 ** 31 / 3):
            return None
        c += int(cv_round(xc))
        r += int(cv_round(xr))
        layer += int(cv_round(xi))
        if (layer < 1 or layer > nL
                or c < border or c >= img.shape[1] - border
                or r < border or r >= img.shape[0] - border):
            return None
    else:
        return None  # i reached max steps without converging

    idx = octv * (nL + 2) + layer
    img, prev, nxt = dog[idx], dog[idx - 1], dog[idx + 1]
    dD = np.array([
        (img[r, c + 1] - img[r, c - 1]) * deriv_scale,
        (img[r + 1, c] - img[r - 1, c]) * deriv_scale,
        (nxt[r, c] - prev[r, c]) * deriv_scale,
    ], np.float64)
    t = float(dD @ np.array([xc, xr, xi]))
    contr = float(img[r, c]) * img_scale + t * 0.5
    if abs(contr) * nL < cfg.contrast_threshold:
        return None
    v2 = float(img[r, c]) * 2.0
    dxx = (img[r, c + 1] + img[r, c - 1] - v2) * second_deriv_scale
    dyy = (img[r + 1, c] + img[r - 1, c] - v2) * second_deriv_scale
    dxy = (img[r + 1, c + 1] - img[r + 1, c - 1]
           - img[r - 1, c + 1] + img[r - 1, c - 1]) * cross_deriv_scale
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    eT = cfg.edge_threshold
    if det <= 0 or tr * tr * eT >= (eT + 1) ** 2 * det:
        return None

    return dict(
        x=(c + xc) * (1 << octv),
        y=(r + xr) * (1 << octv),
        octave=octv, layer=layer, xi=xi,
        r=r, c=c,
        size=cfg.sigma * 2.0 ** ((layer + xi) / nL) * (1 << octv) * 2,
        response=abs(contr),
    )


def _calc_orientation_hist(img: np.ndarray, x: int, y: int, radius: int,
                           sigma: float, n: int) -> np.ndarray:
    """Twin of calcOrientationHist (src/sift.cpp:389-458).

    Note the reference weights by exp over *grid* offsets (i,j), skips
    samples with y<=0 / y>=rows-1 (borders excluded), and gradients are
    unhalved central differences on the Gaussian layer.
    """
    rows, cols = img.shape
    expf_scale = -1.0 / (2.0 * sigma * sigma)
    X, Y, W = [], [], []
    for i in range(-radius, radius + 1):
        yy = y + i
        if yy <= 0 or yy >= rows - 1:
            continue
        for j in range(-radius, radius + 1):
            xx = x + j
            if xx <= 0 or xx >= cols - 1:
                continue
            X.append(float(img[yy, xx + 1]) - float(img[yy, xx - 1]))
            Y.append(float(img[yy - 1, xx]) - float(img[yy + 1, xx]))
            W.append((i * i + j * j) * expf_scale)
    temphist = np.zeros(n, np.float64)
    if X:
        X = np.array(X, np.float32)
        Y = np.array(Y, np.float32)
        W = np.exp(np.array(W, np.float32))
        Ori = fast_atan2_deg(Y, X)
        Mag = np.sqrt(X * X + Y * Y)
        bins = cv_round((n / 360.0) * Ori)
        bins = np.where(bins >= n, bins - n, bins)
        bins = np.where(bins < 0, bins + n, bins)
        np.add.at(temphist, bins, W * Mag)
    # circular (1,4,6,4,1)/16 smoothing (src/sift.cpp:440-451)
    t = temphist
    hist = np.empty(n, np.float64)
    for i in range(n):
        hist[i] = ((t[(i - 2) % n] + t[(i + 2) % n]) * (1.0 / 16)
                   + (t[(i - 1) % n] + t[(i + 1) % n]) * (4.0 / 16)
                   + t[i] * (6.0 / 16))
    return hist.astype(np.float32)


def find_scale_space_extrema(gpyr: List[np.ndarray], dog: List[np.ndarray],
                             cfg: SIFTConfig = DEFAULT_CONFIG) -> List[dict]:
    """Twin of findScaleSpaceExtrema (src/sift.cpp:462-577).

    26-neighbor NMS with ties (>=/<=), |val| > 8 literal threshold,
    5 px border, then refinement + orientation peak expansion.
    """
    n = cfg.ori_hist_bins
    nL = cfg.n_octave_layers
    border = cfg.img_border
    thr = cfg.nms_threshold
    kpts: List[dict] = []
    for o in range(cfg.n_octaves):
        for i in range(1, nL + 1):
            idx = o * (nL + 2) + i
            img, prev, nxt = dog[idx], dog[idx - 1], dog[idx + 1]
            rows, cols = img.shape
            for r in range(border, rows - border):
                for c in range(border, cols - border):
                    val = img[r, c]
                    if abs(val) <= thr:
                        continue
                    cube = np.stack([prev[r - 1:r + 2, c - 1:c + 2],
                                     img[r - 1:r + 2, c - 1:c + 2],
                                     nxt[r - 1:r + 2, c - 1:c + 2]])
                    if val > 0:
                        if not (val >= cube).all():
                            continue
                    else:
                        if not (val <= cube).all():
                            continue
                    kp = _adjust_local_extrema(dog, o, i, r, c, cfg)
                    if kp is None:
                        continue
                    scl_octv = kp["size"] * 0.5 / (1 << o)
                    layer_img = gpyr[o * cfg.n_scales + kp["layer"]]
                    hist = _calc_orientation_hist(
                        layer_img, kp["c"], kp["r"],
                        int(cv_round(cfg.ori_radius_fctr * scl_octv)),
                        cfg.ori_sig_fctr * scl_octv, n)
                    mag_thr = float(hist.max()) * cfg.ori_peak_ratio
                    for j in range(n):
                        l = j - 1 if j > 0 else n - 1
                        r2 = j + 1 if j < n - 1 else 0
                        if hist[j] > hist[l] and hist[j] > hist[r2] \
                                and hist[j] >= mag_thr:
                            b = j + 0.5 * (hist[l] - hist[r2]) / (
                                hist[l] - 2 * hist[j] + hist[r2])
                            b = b + n if b < 0 else (b - n if b >= n else b)
                            angle = 360.0 - (360.0 / n) * b
                            if abs(angle - 360.0) < FLT_EPSILON:
                                angle = 0.0
                            kp2 = dict(kp)
                            kp2["angle"] = angle
                            kpts.append(kp2)
    return kpts


def _calc_sift_descriptor(img: np.ndarray, ptf_x: float, ptf_y: float,
                          ori: float, scl: float, d: int, n: int,
                          cfg: SIFTConfig) -> np.ndarray:
    """Twin of calcSIFTDescriptor (src/sift.cpp:579-722)."""
    rows, cols = img.shape
    pt_x = int(cv_round(ptf_x))
    pt_y = int(cv_round(ptf_y))
    cos_t = math.cos(ori * math.pi / 180.0)
    sin_t = math.sin(ori * math.pi / 180.0)
    bins_per_rad = n / 360.0
    exp_scale = -1.0 / (d * d * 0.5)
    hist_width = cfg.descr_scl_fctr * scl
    radius = int(cv_round(hist_width * math.sqrt(2) * (d + 1) * 0.5))
    radius = min(radius, int(math.sqrt(float(cols) ** 2 + float(rows) ** 2)))
    cos_t /= hist_width
    sin_t /= hist_width

    hist = np.zeros((d + 2, d + 2, n + 2), np.float64)
    ii = np.arange(-radius, radius + 1)
    jj = np.arange(-radius, radius + 1)
    J, I = np.meshgrid(jj, ii)
    c_rot = J * cos_t - I * sin_t
    r_rot = J * sin_t + I * cos_t
    rbin = r_rot + d / 2 - 0.5
    cbin = c_rot + d / 2 - 0.5
    R = pt_y + I
    C = pt_x + J
    valid = ((rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d)
             & (R > 0) & (R < rows - 1) & (C > 0) & (C < cols - 1))
    Rv, Cv = R[valid], C[valid]
    dx = (img[Rv, Cv + 1] - img[Rv, Cv - 1]).astype(np.float32)
    dy = (img[Rv - 1, Cv] - img[Rv + 1, Cv]).astype(np.float32)
    rb, cb = rbin[valid], cbin[valid]
    w = np.exp(((c_rot ** 2 + r_rot ** 2) * exp_scale)[valid]).astype(np.float32)
    Ori = fast_atan2_deg(dy, dx)
    Mag = np.sqrt(dx * dx + dy * dy)
    obin = (Ori - ori) * bins_per_rad
    mag = Mag * w

    r0 = np.floor(rb).astype(np.int64)
    c0 = np.floor(cb).astype(np.int64)
    o0 = np.floor(obin).astype(np.int64)
    rb = rb - r0
    cb = cb - c0
    ob = obin - o0
    o0 = np.where(o0 < 0, o0 + n, o0)
    o0 = np.where(o0 >= n, o0 - n, o0)

    v_r1 = mag * rb
    v_r0 = mag - v_r1
    v_rc11 = v_r1 * cb
    v_rc10 = v_r1 - v_rc11
    v_rc01 = v_r0 * cb
    v_rc00 = v_r0 - v_rc01
    for vals, dr, dc in ((v_rc00, 0, 0), (v_rc01, 0, 1),
                         (v_rc10, 1, 0), (v_rc11, 1, 1)):
        hi = vals * ob
        lo = vals - hi
        np.add.at(hist, (r0 + 1 + dr, c0 + 1 + dc, o0), lo)
        np.add.at(hist, (r0 + 1 + dr, c0 + 1 + dc, o0 + 1), hi)

    dst = np.empty(d * d * n, np.float32)
    for i in range(d):
        for j in range(d):
            h = hist[i + 1, j + 1]
            h[0] += h[n]
            h[1] += h[n + 1]
            dst[(i * d + j) * n:(i * d + j) * n + n] = h[:n]

    # normalization chain (src/sift.cpp:689-721): L2 clip -> x512 ->
    # uchar saturate -> re-multiply -> L1 normalize -> sqrt
    nrm2 = float((dst * dst).sum())
    thr = math.sqrt(nrm2) * cfg.descr_mag_thr
    dst = np.minimum(dst, thr)
    nrm2 = float((dst * dst).sum())
    nrm2 = cfg.int_descr_fctr / max(math.sqrt(nrm2), float(FLT_EPSILON))
    dst = np.clip(cv_round(dst * nrm2), 0, 255).astype(np.float32)
    dst = dst * np.float32(nrm2)
    nrm1 = 1.0 / max(float(dst.sum()), float(FLT_EPSILON))
    return np.sqrt(dst * np.float32(nrm1)).astype(np.float32)


def calc_descriptors(gpyr: List[np.ndarray], kpts: List[dict],
                     cfg: SIFTConfig = DEFAULT_CONFIG) -> np.ndarray:
    """Twin of calDescriptor (src/sift.cpp:733-753)."""
    d, n = cfg.descr_width, cfg.descr_hist_bins
    out = np.zeros((len(kpts), d * d * n), np.float32)
    for i, kp in enumerate(kpts):
        octave, layer = kp["octave"], kp["layer"]
        scale = 1.0 / (1 << octave)
        size = kp["size"] * scale
        ptf_x, ptf_y = kp["x"] * scale, kp["y"] * scale
        img = gpyr[octave * cfg.n_scales + layer]
        angle = 360.0 - kp["angle"]
        if abs(angle - 360.0) < FLT_EPSILON:
            angle = 0.0
        out[i] = _calc_sift_descriptor(img, ptf_x, ptf_y, angle,
                                       size * 0.5, d, n, cfg)
    return out


def sift_ncl(img: np.ndarray, cfg: SIFTConfig = DEFAULT_CONFIG
             ) -> Tuple[List[dict], np.ndarray]:
    """Twin of SIFT_NCL (src/sift.cpp:59-91): detect + describe."""
    gpyr = build_gaussian_pyramid(img, cfg)
    dog = build_dog_pyramid(gpyr, cfg)
    kpts = find_scale_space_extrema(gpyr, dog, cfg)
    desc = calc_descriptors(gpyr, kpts, cfg)
    return kpts, desc


def match_l1_ratio(query: np.ndarray, train: np.ndarray,
                   ratio: float = 0.86) -> List[Tuple[int, int, float]]:
    """Twin of BFMatcher(NORM_L1).knnMatch k=2 + ratio test
    (src/main.cpp:25-40). Returns (query_idx, train_idx, distance).
    """
    good = []
    if len(query) == 0 or len(train) < 2:
        return good
    for qi in range(len(query)):
        dist = np.abs(train - query[qi][None, :]).sum(axis=1)
        i1, i2 = np.argsort(dist, kind="stable")[:2]
        if dist[i1] <= ratio * dist[i2]:
            good.append((qi, int(i1), float(dist[i1])))
    return good
