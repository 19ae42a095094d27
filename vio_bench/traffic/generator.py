"""The benchmark's one traffic generator: synthetic camera-IMU sequences,
batched over rows, made on the device from a seed.

A traffic mix is a JSON file beside this module (``<name>.json``) that
names a trajectory (waypoint segments, repeated for ``laps``), a box of
world points with random unit descriptors, the camera, and the noise of
the IMU and of the pixels. Every row is one noise realisation of the same
trajectory: its own world points, IMU white noise, bias walks and pixel
noise, all drawn from one ``torch.Generator`` seeded with ``--seed``.

The arithmetic is that of the reference's synthetic source (segment poses
by a parabola through three waypoints, or a line through two, with Slerp
orientations; IMU from pose finite differences; pinhole projection of the
points visible in each frame) and of its stream preparation (gravity-aligned
initial orientation, a propagate-only prefix, camera-frame blocks of IMU
ticks, keypoints padded to the configuration's capacity). The frozen NumPy
copy in ``vio_bench/tests/numpy_generator.py`` checks it.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import torch

TRAFFIC_DIR = Path(__file__).resolve().parent
F64 = torch.float64
# frames projected per chunk; fixed, so the order of the pixel-noise draws
# depends on nothing but the seed
FRAME_CHUNK = 16


def load_traffic(name: str) -> dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


# --------------------------------------------------------------------------
# the trajectory (the same for every row)
# --------------------------------------------------------------------------


def _euler_xyz(e: torch.Tensor) -> torch.Tensor:
    """Intrinsic X-Y-Z Euler angles to a rotation matrix: Rx Ry Rz."""
    a, b, c = e.unbind(-1)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    ca, sa, cb, sb, cc, sc = a.cos(), a.sin(), b.cos(), b.sin(), c.cos(), c.sin()
    Rx = torch.stack([one, zero, zero, zero, ca, -sa, zero, sa, ca], -1).reshape(3, 3)
    Ry = torch.stack([cb, zero, sb, zero, one, zero, -sb, zero, cb], -1).reshape(3, 3)
    Rz = torch.stack([cc, -sc, zero, sc, cc, zero, zero, zero, one], -1).reshape(3, 3)
    return Rx @ Ry @ Rz


def skew(w: torch.Tensor) -> torch.Tensor:
    x, y, z = w.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(*w.shape[:-1], 3, 3)


def exp_so3(rv: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula for rotation vectors (..., 3)."""
    th = torch.linalg.vector_norm(rv, dim=-1)[..., None, None]
    K = skew(rv)
    safe = torch.where(th > 0, th, torch.ones_like(th))
    I3 = torch.eye(3, dtype=rv.dtype, device=rv.device).expand(K.shape)
    R = I3 + torch.sin(safe) / safe * K + (1 - torch.cos(safe)) / safe**2 * (K @ K)
    return torch.where(th > 0, R, I3)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector of one rotation matrix with angle in [0, pi)."""
    cos = ((torch.trace(R) - 1) / 2).clamp(-1.0, 1.0)
    th = torch.arccos(cos)
    v = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if float(th) == 0.0:
        return torch.zeros(3, dtype=R.dtype, device=R.device)
    return v * (th / (2 * torch.sin(th)))


def segment_poses(positions, eulers, rate: float, device):
    """Poses along one segment: two waypoints a line, three the parabola
    through them at t = 0, 1/2, 1 (what a not-a-knot cubic spline gives
    for three knots); orientations by Slerp between the two end Euler
    angles; ``int(length * rate)`` samples."""
    wp = torch.tensor(positions, dtype=F64, device=device)
    if len(wp) == 2:
        dist = float(torch.linalg.vector_norm(wp[1] - wp[0]))
    elif len(wp) == 3:
        dist = float(torch.linalg.vector_norm(wp[1] - wp[0]) + torch.linalg.vector_norm(wp[2] - wp[1]))
    else:
        raise ValueError("a segment takes 2 (linear) or 3 (parabola) waypoints")
    n = int(dist * rate)
    t = torch.linspace(0.0, 1.0, n, dtype=F64, device=device)[:, None]
    if len(wp) == 2:
        pos = (1 - t) * wp[0] + t * wp[1]
    else:
        pos = (2 * (t - 0.5) * (t - 1)) * wp[0] - (4 * t * (t - 1)) * wp[1] + (2 * t * (t - 0.5)) * wp[2]
    R0 = _euler_xyz(torch.tensor(eulers[0], dtype=F64, device=device))
    R1 = _euler_xyz(torch.tensor(eulers[1], dtype=F64, device=device))
    rv = log_so3(R0.T @ R1)
    return R0 @ exp_so3(t * rv), pos


def trajectory(p: dict, device):
    """(poses_R (T, 3, 3), poses_t (T, 3)): the stationary prefix, then the
    segments, ``laps`` times."""
    Rs = [torch.eye(3, dtype=F64, device=device).expand(p["stationary_prefix"], 3, 3)]
    ts = [torch.zeros(p["stationary_prefix"], 3, dtype=F64, device=device)]
    for _ in range(p["laps"]):
        for seg in p["segments"]:
            R, t = segment_poses(seg["positions"], seg["eulers_xyz"], p["rate_hz"], device)
            Rs.append(R)
            ts.append(t)
    return torch.cat(Rs), torch.cat(ts)


def _quat_xyzw(R: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (x, y, z, w) of rotation matrices (T, 3, 3), each
    from the largest of the four candidate pivots."""
    m = R
    tr = m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]
    cands = torch.stack([
        torch.stack([m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0], m[:, 1, 0] - m[:, 0, 1], 1 + tr], -1),
        torch.stack([1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2], m[:, 0, 1] + m[:, 1, 0],
                     m[:, 0, 2] + m[:, 2, 0], m[:, 2, 1] - m[:, 1, 2]], -1),
        torch.stack([m[:, 0, 1] + m[:, 1, 0], 1 + m[:, 1, 1] - m[:, 0, 0] - m[:, 2, 2],
                     m[:, 1, 2] + m[:, 2, 1], m[:, 0, 2] - m[:, 2, 0]], -1),
        torch.stack([m[:, 0, 2] + m[:, 2, 0], m[:, 1, 2] + m[:, 2, 1],
                     1 + m[:, 2, 2] - m[:, 0, 0] - m[:, 1, 1], m[:, 1, 0] - m[:, 0, 1]], -1),
    ], 1)  # (T, 4 pivots, 4)
    pivot = torch.stack([tr, m[:, 0, 0], m[:, 1, 1], m[:, 2, 2]], -1).argmax(-1)
    q = cands[torch.arange(len(m), device=m.device), pivot]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def analytic_imu(poses_R, poses_t, dt: float, gravity):
    """Body-frame gyro and accelerometer from pose finite differences;
    tick 0 reads zero."""
    T = len(poses_t)
    vel = torch.zeros_like(poses_t)
    vel[1:] = (poses_t[1:] - poses_t[:-1]) / dt
    acc = torch.zeros_like(poses_t)
    a_w = (vel[1:] - vel[:-1]) / dt + gravity
    acc[1:] = torch.einsum("tji,tj->ti", poses_R[:-1], a_w)
    q = _quat_xyzw(poses_R)
    q1, q2 = q[:-1], q[1:]
    q2 = torch.where((q1 * q2).sum(-1, keepdim=True) < 0, -q2, q2)
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    gyro = torch.zeros(T, 3, dtype=poses_t.dtype, device=poses_t.device)
    gyro[1:] = (2.0 / dt) * torch.stack([
        w1 * x2 - x1 * w2 - y1 * z2 + z1 * y2,
        w1 * y2 + x1 * z2 - y1 * w2 - z1 * x2,
        w1 * z2 - x1 * y2 + y1 * x2 - z1 * w2,
    ], -1)
    return gyro, acc


def gravity_align(mean_acc: torch.Tensor, gravity: torch.Tensor) -> torch.Tensor:
    """R_W_I (rows, 3, 3) turning each row's mean body-frame accelerometer
    onto gravity (the stream preparation's initial orientation)."""
    g = gravity / torch.linalg.vector_norm(gravity)
    a = mean_acc / torch.linalg.vector_norm(mean_acc, dim=-1, keepdim=True)
    axis = torch.linalg.cross(a, g.expand_as(a), dim=-1)
    n = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    theta = torch.arccos((a @ g).clamp(-1.0, 1.0))
    axis = axis / torch.where(n > 0, n, torch.ones_like(n))
    R = exp_so3(axis * theta[:, None])
    I3 = torch.eye(3, dtype=R.dtype, device=R.device)
    # the reference's np.isclose(theta, 0) and np.isclose(theta, pi) cases
    near0 = (theta.abs() <= 1e-8)[:, None, None]
    nearpi = ((theta - math.pi).abs() <= 1e-8 + 1e-5 * math.pi)[:, None, None]
    return torch.where(near0, I3, torch.where(nearpi, -I3, R))


# --------------------------------------------------------------------------
# the rows' random draws
# --------------------------------------------------------------------------


@dataclass
class Draws:
    """Every random number of a batch of rows. ``pixel(j0, j1)`` gives the
    standard normal pixel noise (rows, j1 - j0, points, 2) of camera
    frames j0..j1-1 (frame 0 at tick 0)."""

    point_u: torch.Tensor  # (rows, P, 3) uniform [0, 1)
    desc_u: torch.Tensor  # (rows, P, Dp) uniform [0, 1)
    n_gyro: torch.Tensor  # (rows, T, 3) standard normal
    n_acc: torch.Tensor
    n_bg: torch.Tensor
    n_ba: torch.Tensor
    pixel: object

    @classmethod
    def from_seed(cls, p: dict, rows: int, n_ticks: int, seed: int, device) -> "Draws":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (1 << 64))
        P, Dp = p["world_points"], p["point_desc_dim"]

        def u(*shape):
            return torch.rand(shape, generator=gen, dtype=F64, device=device)

        def n(*shape):
            return torch.randn(shape, generator=gen, dtype=F64, device=device)

        point_u, desc_u = u(rows, P, 3), u(rows, P, Dp)
        imu = [n(rows, n_ticks, 3) for _ in range(4)]

        def pixel(j0, j1):
            return n(rows, j1 - j0, P, 2)

        return cls(point_u, desc_u, *imu, pixel=pixel)

    @classmethod
    def from_arrays(cls, point_u, desc_u, n_gyro, n_acc, n_bg, n_ba, n_pixel) -> "Draws":
        """Given draws (the tests'); ``n_pixel`` is (rows, frames, P, 2)."""
        return cls(point_u, desc_u, n_gyro, n_acc, n_bg, n_ba,
                   pixel=lambda j0, j1: n_pixel[:, j0:j1])


# --------------------------------------------------------------------------
# the stream
# --------------------------------------------------------------------------


@dataclass
class Traffic:
    """One batch of rows, laid out as the program's batched loop takes it:
    ``prefix`` fields (rows, Bp, ...), ``frames`` fields (rows, C, ...),
    in the filter's dtype (keypoint masks bool); ``R_init`` (rows, 3, 3)
    float64. ``n_ticks``: IMU ticks in a row."""

    R_init: torch.Tensor
    prefix: dict
    frames: dict
    n_ticks: int
    world_points: torch.Tensor  # (rows, P, 3) float64
    poses_t: torch.Tensor  # (T, 3) float64 ground truth

    @property
    def n_frames(self) -> int:
        return self.frames["imu_ts"].shape[1]


def make_traffic(p: dict, rows: int, draws: Draws | None, seed: int, dtype: torch.dtype,
                 k_max: int, desc_dim: int, device) -> Traffic:
    """The batch of ``rows`` sequences of traffic ``p``: IMU and keypoints
    (as the reference's synthetic source makes them), prepared as its
    stream preparation does (camera frame 0 dropped, frame 1 the
    initialisation trigger, the prefix up to frame 2)."""
    dev = torch.device(device)
    rate = float(p["rate_hz"])
    dt = 1.0 / rate
    gravity = torch.tensor(p["gravity"], dtype=F64, device=dev)
    K = torch.tensor(p["camera_K"], dtype=F64, device=dev)
    R_IC = torch.tensor(p["camera_R_IC"], dtype=F64, device=dev)
    W, H = p["width"], p["height"]

    poses_R, poses_t = trajectory(p, dev)
    T = len(poses_t)
    if draws is None:
        draws = Draws.from_seed(p, rows, T, seed, dev)
    gyro_gt, acc_gt = analytic_imu(poses_R, poses_t, dt, gravity)
    ts = torch.arange(T, dtype=F64, device=dev) * dt

    wp = draws.point_u * torch.tensor(p["box_scale"], dtype=F64, device=dev) \
        + torch.tensor(p["box_origin"], dtype=F64, device=dev)
    wd = draws.desc_u / torch.linalg.vector_norm(draws.desc_u, dim=-1, keepdim=True)
    gyro = gyro_gt + p["sigma_gyro"] * draws.n_gyro
    acc = acc_gt + p["sigma_acc"] * draws.n_acc
    gyro = gyro + torch.cumsum(p["sigma_bg"] * draws.n_bg, dim=1)
    acc = acc + torch.cumsum(p["sigma_ba"] * draws.n_ba, dim=1)
    gyro[:, 0] = 0
    acc[:, 0] = 0

    every = p["camera_every"]
    cam_ticks = torch.arange(0, T, every, device=dev)  # frame 0 at tick 0
    n_cam = len(cam_ticks)
    if n_cam < 3:
        raise ValueError("the traffic needs at least three camera frames")
    init_tick, first = int(cam_ticks[1]), int(cam_ticks[2])
    R_init = gravity_align(acc[:, : init_tick + 1].mean(dim=1), gravity)

    def cast(x):
        return x.to(dtype)

    prefix = dict(
        imu_ts=cast(ts[:first].expand(rows, first)).contiguous(),
        imu_gyro=cast(gyro[:, :first]).contiguous(),
        imu_acc=cast(acc[:, :first]).contiguous(),
        imu_valid=torch.ones(rows, first, dtype=torch.bool, device=dev),
        pre_init=(torch.arange(first, device=dev) <= init_tick).expand(rows, first).contiguous(),
    )

    # camera-frame blocks: processed frames 2.. (ticks first, first + every,
    # ...), each up to the next one, the last to the end
    proc = cam_ticks[2:]
    C = len(proc)
    bounds = torch.cat([proc, torch.tensor([T], device=dev)])
    lens = bounds[1:] - bounds[:-1]
    B = int(lens.max())
    tick_idx = proc[:, None] + torch.arange(B, device=dev)[None, :]  # (C, B)
    valid = torch.arange(B, device=dev)[None, :] < lens[:, None]
    tick_idx = torch.where(valid, tick_idx, torch.zeros_like(tick_idx))
    zero = torch.zeros((), dtype=F64, device=dev)
    frames = dict(
        imu_ts=cast(torch.where(valid, ts[tick_idx], zero).expand(rows, C, B)).contiguous(),
        imu_gyro=cast(torch.where(valid[..., None], gyro[:, tick_idx], zero)),
        imu_acc=cast(torch.where(valid[..., None], acc[:, tick_idx], zero)),
        imu_valid=valid.expand(rows, C, B).contiguous(),
        has_camera=torch.ones(rows, C, dtype=torch.bool, device=dev),
        kp=torch.zeros(rows, C, k_max, 2, dtype=dtype, device=dev),
        desc=torch.zeros(rows, C, k_max, desc_dim, dtype=dtype, device=dev),
        score=torch.zeros(rows, C, k_max, dtype=dtype, device=dev),
        kp_valid=torch.zeros(rows, C, k_max, dtype=torch.bool, device=dev),
    )
    Dp = wd.shape[-1]
    if Dp > desc_dim:
        raise ValueError(f"point descriptors of {Dp} > desc_dim {desc_dim}")
    score_noisy = 1.0 / (1.0 + 2.0 * p["sigma_pixel"] ** 2)
    rows_ix = torch.arange(rows, device=dev)[:, None, None]
    # frames 0 and 1 are drawn (their pixel noise keeps the draws in frame
    # order) and never processed
    for j0 in range(0, n_cam, FRAME_CHUNK):
        j1 = min(j0 + FRAME_CHUNK, n_cam)
        noise = draws.pixel(j0, j1)  # (rows, n, P, 2)
        tk = cam_ticks[j0:j1]
        R_wc = poses_R[tk] @ R_IC  # (n, 3, 3)
        pc = torch.einsum("rnpk,nkj->rnpj", wp[:, None] - poses_t[tk][None, :, None], R_wc)
        uvw = pc @ K.T
        uv = uvw[..., :2] / uvw[..., 2:3]
        vis = (pc[..., 2] > 0) & (uv[..., 0] >= 0) & (uv[..., 0] < W) & (uv[..., 1] >= 0) & (uv[..., 1] < H)
        kp = uv + p["sigma_pixel"] * noise
        slot = torch.cumsum(vis, dim=-1) - 1  # compact the visible points in point order
        if int(slot[..., -1].max()) >= k_max:
            raise ValueError(f"a frame sees more than k_max = {k_max} points")
        lo = max(j0, 2)
        if lo >= j1:
            continue
        sel = slice(lo - j0, j1 - j0)
        vis, slot, kp = vis[:, sel], slot[:, sel], kp[:, sel]
        n = j1 - lo
        c_ix = (torch.arange(n, device=dev) + lo - 2)[None, :, None].expand_as(slot)
        r_ix = rows_ix.expand_as(slot)
        r_ix, c_ix, s_ix = r_ix[vis], c_ix[vis], slot[vis]
        frames["kp"][r_ix, c_ix, s_ix] = cast(kp[vis])
        p_ix = torch.arange(wp.shape[1], device=dev).expand_as(slot)[vis]
        frames["desc"][r_ix, c_ix, s_ix, :Dp] = cast(wd[r_ix, p_ix])
        frames["score"][r_ix, c_ix, s_ix] = score_noisy
        frames["kp_valid"][r_ix, c_ix, s_ix] = True
    return Traffic(R_init=R_init, prefix=prefix, frames=frames, n_ticks=T,
                   world_points=wp, poses_t=poses_t)
