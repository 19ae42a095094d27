"""Rendered-image sequences (host-side NumPy; the port's own copy of
``msckf_tpu/data/rendered.py``, kept here because importing any
``msckf_tpu`` module imports JAX).

A ray-traced, procedurally textured ground plane (optionally with textured
boxes standing on it) under a pinhole camera flying a circle, with
analytically consistent IMU. The arithmetic and the order of random draws are
the JAX package's, so one seed renders the same images bit for bit in both
packages. The images are the ground truth here: keypoints come from the
XFeat front-end (``msckf_tpu_torch/models/xfeat.py``), which makes this the
image-in pipeline's fixture (images -> CNN -> matching -> filter).

The texture is an infinite hashed-lattice multi-octave value noise plus one
rectangle or ellipse decal per world cell: evaluable at arbitrary world
coordinates, deterministic in the seed, band-limited enough for stable
interest points.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from msckf_tpu_torch.data.synthetic import analytic_imu


def _hash01(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic lattice hash -> [0, 1)."""
    # uint64 arithmetic: the multiplies wrap by design (lattice hash) and
    # int64 RuntimeWarns on overflow; the masked low bits are identical.
    # ix/iy are (possibly negative) floored floats — float->uint64 is
    # undefined, so cast through int64 (two's complement) first.
    h = (
        ix.astype(np.int64).astype(np.uint64) * np.uint64(73856093)
        ^ iy.astype(np.int64).astype(np.uint64) * np.uint64(19349663)
        ^ np.uint64(seed) * np.uint64(83492791)
    ) & np.uint64(0x7FFFFFFF)
    h = (h * np.uint64(2654435761)) & np.uint64(0xFFFFFFFF)
    return (h / 2.0**32).astype(np.float32)


def plane_texture(x: np.ndarray, y: np.ndarray, seed: int = 0,
                  octaves=(0.5, 1.0, 2.0, 4.0, 8.0),
                  decal_cell: float = 0.5) -> np.ndarray:
    """Procedural texture T(x, y) in [0, 255] at world coords (meters):
    multi-octave value noise + world-anchored rectangle/ellipse decals (one
    per ``decal_cell`` grid cell) — the decals give the plane the corner-rich
    structure a keypoint detector needs (smooth noise alone has none)."""
    out = np.zeros(x.shape, np.float32)
    amp = 1.0
    total = 0.0
    for k, freq in enumerate(octaves):
        gx = x * freq
        gy = y * freq
        ix = np.floor(gx)
        iy = np.floor(gy)
        fx = (gx - ix).astype(np.float32)
        fy = (gy - iy).astype(np.float32)
        # smoothstep for C1 continuity
        fx = fx * fx * (3 - 2 * fx)
        fy = fy * fy * (3 - 2 * fy)
        s = seed * 31 + k
        a = _hash01(ix, iy, s)
        b = _hash01(ix + 1, iy, s)
        c = _hash01(ix, iy + 1, s)
        d = _hash01(ix + 1, iy + 1, s)
        out += amp * ((1 - fy) * ((1 - fx) * a + fx * b) + fy * ((1 - fx) * c + fx * d))
        total += amp
        amp *= 0.55
    noise = out / total

    # decals: each (decal_cell x decal_cell) world cell holds one random
    # rectangle or ellipse, parameters hashed from the cell index
    gx = x / decal_cell
    gy = y / decal_cell
    ix = np.floor(gx)
    iy = np.floor(gy)
    fx = (gx - ix).astype(np.float32)  # position within the cell [0, 1)
    fy = (gy - iy).astype(np.float32)
    ds = seed * 131 + 7
    cx = 0.25 + 0.5 * _hash01(ix, iy, ds + 1)
    cy = 0.25 + 0.5 * _hash01(ix, iy, ds + 2)
    hw = 0.08 + 0.30 * _hash01(ix, iy, ds + 3)
    hh = 0.08 + 0.30 * _hash01(ix, iy, ds + 4)
    val = _hash01(ix, iy, ds + 5)
    is_rect = _hash01(ix, iy, ds + 6) < 0.5
    dx = np.abs(fx - cx)
    dy = np.abs(fy - cy)
    inside = np.where(
        is_rect,
        (dx < hw) & (dy < hh),
        (dx / hw) ** 2 + (dy / hh) ** 2 < 1.0,
    )
    tex = np.where(inside, 0.35 * noise + 0.65 * val, noise)
    return tex * 255.0


def render_plane_view(R_WC: np.ndarray, t_WC: np.ndarray, K: np.ndarray,
                      width: int, height: int, seed: int = 0) -> np.ndarray:
    """Ray-trace the z=0 textured plane through a pinhole camera.

    Pixels whose rays don't hit the plane in front of the camera render 0.
    """
    Kinv = np.linalg.inv(K)
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    pix = np.stack([xs + 0.0, ys + 0.0, np.ones_like(xs, dtype=np.float64)], -1)
    rays_c = pix @ Kinv.T  # camera-frame directions
    rays_w = rays_c @ R_WC.T  # world directions
    # intersect z = 0: t = -cz / dz
    dz = rays_w[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        tt = -t_WC[2] / dz
    hit = (tt > 1e-3) & np.isfinite(tt)
    wx = t_WC[0] + tt * rays_w[..., 0]
    wy = t_WC[1] + tt * rays_w[..., 1]
    tex = plane_texture(np.where(hit, wx, 0.0), np.where(hit, wy, 0.0), seed)
    return np.where(hit, tex, 0.0).astype(np.float32)


def make_boxes(rng: np.random.Generator, n_boxes: int = 28,
               r_lo: float = 0.3, r_hi: float = 2.6) -> np.ndarray:
    """Random axis-aligned boxes standing on the z=0 plane inside an annulus
    (under a circular trajectory). Returns (B, 2, 3) min/max corners."""
    ang = rng.uniform(0, 2 * np.pi, n_boxes)
    rad = np.sqrt(rng.uniform(r_lo**2, r_hi**2, n_boxes))
    cx = rad * np.cos(ang)
    cy = rad * np.sin(ang)
    hw = rng.uniform(0.10, 0.40, n_boxes)
    hd = rng.uniform(0.10, 0.40, n_boxes)
    hz = rng.uniform(0.15, 1.20, n_boxes)
    lo = np.stack([cx - hw, cy - hd, np.zeros(n_boxes)], -1)
    hi = np.stack([cx + hw, cy + hd, hz], -1)
    return np.stack([lo, hi], axis=1)


def render_scene_view(R_WC: np.ndarray, t_WC: np.ndarray, K: np.ndarray,
                      width: int, height: int, seed: int = 0,
                      boxes: np.ndarray | None = None) -> np.ndarray:
    """Ray-trace the textured z=0 plane plus textured axis-aligned boxes.

    Out-of-plane structure for the hard full-pipeline fixture (the
    flat-plane fixture never exercises non-planar parallax). Nearest-hit
    shading: each box face carries the procedural texture in its own face
    coordinates with per-face brightness, giving the detector real 3-D
    corners and depth discontinuities.
    """
    if boxes is None or len(boxes) == 0:
        return render_plane_view(R_WC, t_WC, K, width, height, seed)
    Kinv = np.linalg.inv(K)
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    pix = np.stack([xs + 0.0, ys + 0.0, np.ones_like(xs, dtype=np.float64)], -1)
    rays_w = (pix @ Kinv.T) @ R_WC.T  # (H, W, 3) world directions
    o = t_WC

    with np.errstate(divide="ignore", invalid="ignore"):
        t_plane = -o[2] / rays_w[..., 2]
    hit_plane = (t_plane > 1e-3) & np.isfinite(t_plane)
    best_t = np.where(hit_plane, t_plane, np.inf)
    wx = o[0] + best_t * rays_w[..., 0]
    wy = o[1] + best_t * rays_w[..., 1]
    tex = plane_texture(
        np.where(hit_plane, wx, 0.0), np.where(hit_plane, wy, 0.0), seed
    )
    img = np.where(hit_plane, tex, 0.0).astype(np.float32)

    d_safe = np.where(np.abs(rays_w) < 1e-12, 1e-12, rays_w)
    for bi, (lo, hi) in enumerate(boxes):
        t1 = (lo - o) / d_safe  # (H, W, 3)
        t2 = (hi - o) / d_safe
        tn = np.minimum(t1, t2)
        tf = np.maximum(t1, t2)
        axis = np.argmax(tn, axis=-1)  # entering slab = the face hit
        t_near = np.take_along_axis(tn, axis[..., None], -1)[..., 0]
        t_far = np.min(tf, axis=-1)
        hit = (t_near > 1e-3) & (t_near <= t_far) & (t_near < best_t)
        if not hit.any():
            continue
        p = o + t_near[..., None] * rays_w  # (H, W, 3) hit points
        # face texture coordinates: the two coordinates orthogonal to the
        # hit face's normal, at 2x frequency for finer structure
        u = np.where(axis == 0, p[..., 1], p[..., 0])
        v = np.where(axis == 2, p[..., 1], p[..., 2])
        face_tex = plane_texture(
            u * 2.0, v * 2.0, seed + 101 * (bi + 1), octaves=(1.0, 2.0, 4.0)
        )
        shade = np.where(axis == 2, 1.0, np.where(axis == 0, 0.78, 0.62))
        img = np.where(hit, (face_tex * shade).astype(np.float32), img)
        best_t = np.where(hit, t_near, best_t)
    return img


@dataclasses.dataclass
class RenderedSequence:
    timestamps: np.ndarray  # (T,)
    poses_R: np.ndarray  # (T, 3, 3) T_W_Ii
    poses_t: np.ndarray  # (T, 3)
    imu_gyro: np.ndarray  # (T, 3) noisy
    imu_acc: np.ndarray  # (T, 3)
    cam_frame_ticks: np.ndarray  # (C,)
    images: np.ndarray  # (C, H, W) float32 [0, 255]
    R_WC_extrinsic: np.ndarray  # (3, 3) camera-in-IMU rotation used


# camera extrinsic: camera z (optical axis) points down at the world plane,
# camera x right (world x), y down-track (world -y keeps a right-handed frame)
R_WC_DOWN = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, -1.0]])


def oblique_extrinsic(pitch_deg: float = 35.0) -> np.ndarray:
    """Non-trivial camera-in-IMU extrinsic: nadir mount tilted ``pitch_deg``
    about the body y axis so the optical axis looks down-and-inward (toward
    -body.x); the flat fixture's constant axis-aligned R_WC never exercises
    the extrinsic chain. For the circular trajectory (body x radially outward), the
    camera sweeps the box annulus inside the circle."""
    a = np.deg2rad(pitch_deg)
    Ry = np.array(
        [[np.cos(a), 0.0, np.sin(a)],
         [0.0, 1.0, 0.0],
         [-np.sin(a), 0.0, np.cos(a)]]
    )
    return Ry @ R_WC_DOWN


def generate_rendered_circle(
    rng: np.random.Generator | None = None,
    radius: float = 3.0,
    camera_height: float = 4.0,
    rate: float = 200.0,
    camera_every: int = 10,
    n_ticks: int = 2400,
    width: int = 320,
    height: int = 240,
    fxy: float = 180.0,
    seed: int = 0,
    sigma_acc: float = 1e-4,
    sigma_gyro: float = 1e-5,
    stationary_prefix: int = 19,
) -> RenderedSequence:
    """Circular sweep above the textured plane, camera pitched straight down.

    The IMU frame equals the camera frame here (R_WC extrinsic = identity in
    the filter config; pass ``R_WC_DOWN``-composed poses as T_W_Ii and use
    identity camera extrinsics) — the filter sees a monocular-VIO problem
    identical in structure to the reference's photorealistic runs.
    """
    rng = rng or np.random.default_rng(0)
    dt = 1.0 / rate
    T = n_ticks
    tt = np.arange(T) * dt

    # smooth angular ramp from rest (zero-velocity prefix like the reference)
    omega = 2.0 * np.pi / 18.0  # one lap in 18 s
    ramp = np.clip((tt - stationary_prefix * dt) / 2.0, 0.0, 1.0)
    ang = np.cumsum(omega * ramp * dt) if T else np.zeros(0)

    poses_t = np.stack(
        [radius * np.cos(ang), radius * np.sin(ang),
         np.full(T, camera_height)], -1
    )
    # IMU frame: world-aligned axes rotated by yaw = ang (so the body yaws
    # around the circle); camera mounted down via R_WC_DOWN
    cz = np.cos(ang)
    sz = np.sin(ang)
    yaw = np.zeros((T, 3, 3))
    yaw[:, 0, 0] = cz
    yaw[:, 0, 1] = -sz
    yaw[:, 1, 0] = sz
    yaw[:, 1, 1] = cz
    yaw[:, 2, 2] = 1.0
    poses_R = yaw

    gravity = np.array([0.0, 0.0, -9.81])
    gyro_gt, acc_gt = analytic_imu(poses_R, poses_t, dt, gravity)
    gyro = gyro_gt + rng.normal(0, sigma_gyro, (T, 3))
    acc = acc_gt + rng.normal(0, sigma_acc, (T, 3))
    gyro[0] = 0
    acc[0] = 0

    K = np.array([[fxy, 0, width / 2.0], [0, fxy, height / 2.0], [0, 0, 1]])
    cam_ticks = np.arange(0, T, camera_every)
    images = np.empty((len(cam_ticks), height, width), np.float32)
    for j, i in enumerate(cam_ticks):
        R_cam = poses_R[i] @ R_WC_DOWN
        images[j] = render_plane_view(R_cam, poses_t[i], K, width, height, seed)
    # GT re-framed so the first pose is the identity, like the reference's
    # photorealistic re-framing (`photorealistic_generator.py:69-108`) — the
    # filter always starts at the origin. R0 = I here, so a translation.
    poses_t = poses_t - poses_t[0]
    return RenderedSequence(
        timestamps=tt,
        poses_R=poses_R,
        poses_t=poses_t,
        imu_gyro=gyro,
        imu_acc=acc,
        cam_frame_ticks=cam_ticks,
        images=images,
        R_WC_extrinsic=R_WC_DOWN,
    )


def generate_rendered_boxes(
    rng: np.random.Generator | None = None,
    radius: float = 3.0,
    camera_height: float = 2.5,
    rate: float = 200.0,
    camera_every: int = 10,
    n_ticks: int = 2400,
    width: int = 320,
    height: int = 240,
    fxy: float = 180.0,
    seed: int = 0,
    sigma_acc: float = 1e-4,
    sigma_gyro: float = 1e-5,
    stationary_prefix: int = 19,
    pitch_deg: float = 35.0,
    n_boxes: int = 28,
) -> RenderedSequence:
    """The HARD full-pipeline fixture: circular sweep with an
    **oblique** camera (``pitch_deg`` off nadir, looking down-and-inward via
    a non-trivial R_WC extrinsic) over a plane populated with textured
    out-of-plane boxes — non-planar parallax, depth discontinuities, multiple
    texture families and depths, and a camera-IMU extrinsic chain the flat
    nadir fixture never exercised.
    """
    rng = rng or np.random.default_rng(0)
    dt = 1.0 / rate
    T = n_ticks
    tt = np.arange(T) * dt

    omega = 2.0 * np.pi / 18.0
    ramp = np.clip((tt - stationary_prefix * dt) / 2.0, 0.0, 1.0)
    ang = np.cumsum(omega * ramp * dt) if T else np.zeros(0)

    poses_t = np.stack(
        [radius * np.cos(ang), radius * np.sin(ang),
         np.full(T, camera_height)], -1
    )
    cz = np.cos(ang)
    sz = np.sin(ang)
    yaw = np.zeros((T, 3, 3))
    yaw[:, 0, 0] = cz
    yaw[:, 0, 1] = -sz
    yaw[:, 1, 0] = sz
    yaw[:, 1, 1] = cz
    yaw[:, 2, 2] = 1.0
    poses_R = yaw

    gravity = np.array([0.0, 0.0, -9.81])
    gyro_gt, acc_gt = analytic_imu(poses_R, poses_t, dt, gravity)
    gyro = gyro_gt + rng.normal(0, sigma_gyro, (T, 3))
    acc = acc_gt + rng.normal(0, sigma_acc, (T, 3))
    gyro[0] = 0
    acc[0] = 0

    R_WC = oblique_extrinsic(pitch_deg)
    boxes = make_boxes(rng, n_boxes=n_boxes)
    K = np.array([[fxy, 0, width / 2.0], [0, fxy, height / 2.0], [0, 0, 1]])
    cam_ticks = np.arange(0, T, camera_every)
    images = np.empty((len(cam_ticks), height, width), np.float32)
    for j, i in enumerate(cam_ticks):
        R_cam = poses_R[i] @ R_WC
        images[j] = render_scene_view(
            R_cam, poses_t[i], K, width, height, seed, boxes=boxes
        )
    poses_t = poses_t - poses_t[0]
    return RenderedSequence(
        timestamps=tt,
        poses_R=poses_R,
        poses_t=poses_t,
        imu_gyro=gyro,
        imu_acc=acc,
        cam_frame_ticks=cam_ticks,
        images=images,
        R_WC_extrinsic=R_WC,
    )
