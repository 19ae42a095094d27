"""Self-supervised training data for XFeat (host-side NumPy; the port's own
copy of ``msckf_tpu/models/selfsup.py``, kept here because importing any
``msckf_tpu`` module imports JAX): procedural textures, random homographies,
photometric jitter, and a classical-corner teacher.

The arithmetic and the order of random draws are the JAX package's, so one
``np.random.Generator`` seed gives the same arrays bit for bit in both
packages: the frozen front-end benchmark (``weights/frontend_eval_v1.npz``)
and every training batch come from here. The recipe stands in for upstream
XFeat's (MegaDepth and COCO warps with ALIKE keypoint distillation), which
needs external images and a teacher network:

  * image source  -> procedural textures (multi-octave value noise, random
    polygons/ellipses, jittered grids, ray-traced boxes scenes) instead of
    photos;
  * geometric supervision -> exact random homographies (corner-perturbation
    sampling) instead of MegaDepth depth/pose pairs;
  * keypoint teacher -> Shi-Tomasi min-eigenvalue corners instead of ALIKE.
"""

from __future__ import annotations

import dataclasses

import numpy as np


# ----------------------------------------------------------------- textures


def _value_noise(rng: np.random.Generator, size: int, octaves=(4, 8, 16, 32, 64)):
    """Multi-octave bilinear value noise in [0, 1]."""
    img = np.zeros((size, size), np.float32)
    amp = 1.0
    total = 0.0
    for cells in octaves:
        g = rng.random((cells + 1, cells + 1)).astype(np.float32)
        # bilinear upsample to full size
        t = np.linspace(0, cells, size, endpoint=False, dtype=np.float32)
        i0 = np.floor(t).astype(np.int32)
        f = t - i0
        a = g[i0][:, i0]
        b = g[i0][:, i0 + 1]
        c = g[i0 + 1][:, i0]
        d = g[i0 + 1][:, i0 + 1]
        fx = f[None, :]
        fy = f[:, None]
        img += amp * ((1 - fy) * ((1 - fx) * a + fx * b) + fy * ((1 - fx) * c + fx * d))
        total += amp
        amp *= 0.6
    return img / total


def _random_shapes(rng: np.random.Generator, size: int, n=40):
    """Random filled ellipses/rectangles over a noise base — strong corners
    and edges for the corner teacher."""
    img = np.full((size, size), 0.5, np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(n):
        cx, cy = rng.random(2) * size
        w, h = rng.random(2) * size * 0.2 + 4
        ang = rng.random() * np.pi
        ca, sa = np.cos(ang), np.sin(ang)
        dx = (xx - cx) * ca + (yy - cy) * sa
        dy = -(xx - cx) * sa + (yy - cy) * ca
        if rng.random() < 0.5:
            mask = (dx / w) ** 2 + (dy / h) ** 2 < 1.0
        else:
            mask = (np.abs(dx) < w) & (np.abs(dy) < h)
        img[mask] = rng.random()
    return img


def _warped_grid(rng: np.random.Generator, size: int):
    """Sine-warped checkerboard."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    fx, fy = rng.random(2) * 0.15 + 0.05
    wx = np.sin(yy * (rng.random() * 0.05 + 0.01)) * (rng.random() * 10)
    wy = np.sin(xx * (rng.random() * 0.05 + 0.01)) * (rng.random() * 10)
    return (
        (np.floor((xx + wx) * fx) + np.floor((yy + wy) * fy)) % 2
    ).astype(np.float32)


def _rendered_scene(rng: np.random.Generator, size: int) -> np.ndarray:
    """A ray-traced boxes-scene view (the evaluation fixtures' image
    distribution, `data/rendered.py`): random box field, random oblique
    camera. Returned in [0, 1]."""
    from msckf_tpu_torch.data.rendered import (
        R_WC_DOWN,
        make_boxes,
        oblique_extrinsic,
        render_scene_view,
    )

    boxes = make_boxes(rng, n_boxes=int(rng.integers(10, 32)))
    ang = rng.uniform(0, 2 * np.pi)
    radius = rng.uniform(2.0, 4.0)
    height = rng.uniform(2.0, 4.5)
    t = np.array([radius * np.cos(ang), radius * np.sin(ang), height])
    cz, sz = np.cos(ang), np.sin(ang)
    yaw = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    pitch = rng.uniform(0.0, 45.0)
    R_cam = yaw @ (oblique_extrinsic(pitch) if pitch > 1.0 else R_WC_DOWN)
    fxy = rng.uniform(120.0, 220.0)
    K = np.array([[fxy, 0, size / 2.0], [0, fxy, size / 2.0], [0, 0, 1.0]])
    img = render_scene_view(
        R_cam, t, K, size, size, seed=int(rng.integers(1 << 30)), boxes=boxes
    )
    return img / 255.0


def random_texture(rng: np.random.Generator, size: int) -> np.ndarray:
    """A random textured grayscale image in [0, 255]."""
    kind = rng.integers(0, 4)
    if kind == 0:
        img = _value_noise(rng, size)
    elif kind == 1:
        img = 0.6 * _random_shapes(rng, size) + 0.4 * _value_noise(rng, size)
    elif kind == 2:
        img = 0.5 * _warped_grid(rng, size) + 0.5 * _value_noise(rng, size)
    else:
        # ray-traced boxes scenes: the domain the full-pipeline fixtures
        # evaluate on
        img = _rendered_scene(rng, size)
    return (img * 255.0).astype(np.float32)


# -------------------------------------------------------------- homographies


def random_homography(rng: np.random.Generator, size: int, scale: float = 0.15,
                      max_rot: float = 0.5, scale_range: tuple = (0.8, 1.25)):
    """Random similarity (rotation up to ``max_rot`` rad, isotropic scale in
    ``scale_range``) composed with a corner-perturbation homography (corners
    move by up to ``scale * size``; DLT solve) — covering the rotation and
    depth-change viewpoint shifts a moving camera produces."""
    s = float(size - 1)
    src = np.array([[0, 0], [s, 0], [s, s], [0, s]], np.float64)
    ang = rng.uniform(-max_rot, max_rot)
    sc = rng.uniform(*scale_range)
    ca, sa = np.cos(ang) * sc, np.sin(ang) * sc
    ctr = np.array([s / 2, s / 2])
    sim = (src - ctr) @ np.array([[ca, -sa], [sa, ca]]).T + ctr
    dst = sim + rng.uniform(-scale, scale, (4, 2)) * s
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]


def warp_image(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Inverse bilinear warp: out(p) = img(H^-1 p), zeros outside."""
    size = img.shape[0]
    Hi = np.linalg.inv(H)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    w = Hi[2, 0] * xx + Hi[2, 1] * yy + Hi[2, 2]
    sx = (Hi[0, 0] * xx + Hi[0, 1] * yy + Hi[0, 2]) / w
    sy = (Hi[1, 0] * xx + Hi[1, 1] * yy + Hi[1, 2]) / w
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0).astype(np.float32)
    fy = (sy - y0).astype(np.float32)

    def at(yi, xi):
        ok = (xi >= 0) & (xi < size) & (yi >= 0) & (yi < size)
        v = img[np.clip(yi, 0, size - 1), np.clip(xi, 0, size - 1)]
        return np.where(ok, v, 0.0).astype(np.float32)

    return (
        (1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x0 + 1))
        + fy * ((1 - fx) * at(y0 + 1, x0) + fx * at(y0 + 1, x0 + 1))
    )


def photometric_jitter(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    out = img * (0.6 + 0.8 * rng.random()) + (rng.random() - 0.5) * 60.0
    out = out + rng.normal(0, 4.0, img.shape)
    return np.clip(out, 0, 255).astype(np.float32)


# ------------------------------------------------------------ corner teacher


def shi_tomasi_response(img: np.ndarray) -> np.ndarray:
    """Min-eigenvalue corner response (the classical keypoint teacher)."""
    g = img.astype(np.float32) / 255.0
    gx = np.zeros_like(g)
    gy = np.zeros_like(g)
    gx[:, 1:-1] = 0.5 * (g[:, 2:] - g[:, :-2])
    gy[1:-1, :] = 0.5 * (g[2:, :] - g[:-2, :])

    def box(a):  # 5x5 box filter via cumsum
        c = np.cumsum(np.cumsum(np.pad(a, ((3, 2), (3, 2))), axis=0), axis=1)
        return c[5:, 5:] - c[:-5, 5:] - c[5:, :-5] + c[:-5, :-5]

    ixx, iyy, ixy = box(gx * gx), box(gy * gy), box(gx * gy)
    tr = ixx + iyy
    det_rad = np.sqrt(np.maximum(((ixx - iyy) * 0.5) ** 2 + ixy * ixy, 0.0))
    return 0.5 * tr - det_rad  # lambda_min


def labels_from_response(r: np.ndarray, thresh: float = 0.01) -> np.ndarray:
    """Per-8x8-cell teacher label from a corner response map: dominant
    position 0..63 or the dustbin 64 when nothing exceeds ``thresh``
    (matching the keypoint head's 65-way layout)."""
    size = r.shape[0]
    hc = size // 8
    cells = r[: hc * 8, : hc * 8].reshape(hc, 8, hc, 8).transpose(0, 2, 1, 3)
    cells = cells.reshape(hc, hc, 64)
    best = np.argmax(cells, axis=-1)
    has = np.max(cells, axis=-1) > thresh
    return np.where(has, best, 64).astype(np.int32)


def corner_labels(img: np.ndarray, thresh: float = 0.01) -> np.ndarray:
    """Per-8x8-cell teacher label: dominant corner position 0..63 or the
    dustbin 64 when no corner exceeds ``thresh`` (ALIKE-distillation analog,
    matching the keypoint head's 65-way layout)."""
    return labels_from_response(shi_tomasi_response(img), thresh)


def joint_corner_labels(
    base: np.ndarray, warped: np.ndarray, H: np.ndarray, thresh: float = 0.01
) -> tuple[np.ndarray, np.ndarray]:
    """H-consistent teacher labels for a homography pair.

    Independent per-image Shi-Tomasi labels teach the keypoint head
    *inconsistent* detections across the warp (only ~40% of projected
    keypoints had a detection within 3 px; median match error ~3 px, as
    measured on the JAX package). The SuperPoint "homographic
    adaptation" analog: warp each image's response into the other frame and
    label from the geometric mean, so the teacher only fires on corners that
    survive the warp, at positions that agree through H by construction.
    """
    from scipy.ndimage import maximum_filter

    r1 = np.maximum(shi_tomasi_response(base), 0.0)
    r2 = np.maximum(shi_tomasi_response(warped), 0.0)
    r2_in1 = warp_image(r2, np.linalg.inv(H))  # out(p1) = r2(H p1)
    r1_in2 = warp_image(r1, H)  # out(p2) = r1(H^-1 p2)
    c1 = np.sqrt(r1 * r2_in1)
    c2 = np.sqrt(r2 * r1_in2)

    def nms_labels(c):
        # keep only 5x5 NMS peaks before the per-cell argmax: cell-argmax on
        # the raw (box-smoothed, plateau-prone) response drifts under the
        # warp, NMS peaks are warp-stable (measured teacher consistency
        # 0.63 independent -> 0.71 joint -> ~0.87 joint+NMS @2px). Adaptive
        # threshold keeps weak-texture scenes from going all-dustbin.
        peaks = (c >= maximum_filter(c, size=5)) & (c > 0)
        masked = np.where(peaks, c, -np.inf)
        thr = thresh
        if np.sum(masked > thr) < 30:
            thr = 0.25 * float(c.max()) if c.max() > 0 else thresh
        return labels_from_response(masked, thr)

    return nms_labels(c1), nms_labels(c2)


# ------------------------------------------------------------------- batches


@dataclasses.dataclass
class WarpBatch:
    img1: np.ndarray  # (B, S, S) float32 [0, 255]
    img2: np.ndarray  # (B, S, S) warped + jittered
    H: np.ndarray  # (B, 3, 3) img1 -> img2 pixel map
    kp_labels1: np.ndarray  # (B, S/8, S/8) int 0..64
    kp_labels2: np.ndarray  # (B, S/8, S/8)


def make_batch(rng: np.random.Generator, batch: int, size: int = 256,
               **homography_kwargs) -> WarpBatch:
    i1, i2, Hs, l1, l2 = [], [], [], [], []
    for _ in range(batch):
        base = random_texture(rng, size)
        H = random_homography(rng, size, **homography_kwargs)
        warped = warp_image(base, H)
        jit2 = photometric_jitter(rng, warped)
        i1.append(base)
        i2.append(jit2)
        Hs.append(H.astype(np.float32))
        la, lb = joint_corner_labels(base, warped, H)  # H-consistent teacher
        l1.append(la)
        l2.append(lb)
    return WarpBatch(
        img1=np.stack(i1), img2=np.stack(i2), H=np.stack(Hs),
        kp_labels1=np.stack(l1), kp_labels2=np.stack(l2),
    )
