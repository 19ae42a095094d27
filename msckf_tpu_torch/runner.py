"""Experiment driver CLI (port of ``msckf_tpu/runner.py``).

    python -m msckf_tpu_torch.runner --source synthetic --max_frames 2400
    python -m msckf_tpu_torch.runner --source synthetic --device cpu
    python -m msckf_tpu_torch.runner --sequence classic --noise_level mid \
        --gen_noise default --max_frames 30000 --correction_dtype compensated

The JAX package's flag surface (--source --sequence --max_frames
--noise_level --save_results --log_images ...), its noise presets, metrics,
consistency report and results.txt, plus ``--device`` (default ``cuda``;
``cpu`` runs the kernels' plain versions). Without a GPU and without
``--device cpu`` the runner raises; it never carries on on the CPU.

Sources: the synthetic circle and classic (in memory, or on disk under
``--data_root``), the rendered circle and boxes, and datasets in the
TartanAir and PeringLab formats (``{data_root}/{source}/{sequence}/`` with
``trajectory.csv`` and ``cam/``; ``data/photorealistic.py`` writes their
IMU and ground truth first, and ``{data_root}/{source}/camera_info.csv``
gives the camera). PNG rasters are read by ``data/imageio.py``, which needs
no OpenCV.

Paths: the whole stream uploaded and run by ``run_sequence`` (default),
streamed from the host in chunks (``--stream_chunk N``,
``filter/streamed.py``; ``--rerun_live`` logs each fetched chunk to the
Rerun viewer), the image-in pipeline for an image source (``--frontend
fused``), and a batch of noise realizations of the circle (``--batch N``),
on one card, or over several with one rank a card under ``torchrun``:

    torchrun --nproc_per_node 4 -m msckf_tpu_torch.runner --batch 32

Each is timed as a warm-up run, then a timed run that ends in
``torch.cuda.synchronize()``; on the CPU, which has no kernels to build and
no device caches to fill, the one run is the timed run.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from msckf_tpu_torch.config import NOISE_PRESETS, reference_experiment_config
from msckf_tpu_torch.data import imageio
from msckf_tpu_torch.data import parser as parsing
from msckf_tpu_torch.data.photorealistic import generate_photorealistic
from msckf_tpu_torch.data.rendered import generate_rendered_boxes, generate_rendered_circle
from msckf_tpu_torch.data.stream import (
    build_image_stream, build_stream, match_camera_ticks, suggest_capacities, to_device,
)
from msckf_tpu_torch.data.synthetic import generate_circle_sequence, generate_classic_sequence
from msckf_tpu_torch.filter.msckf import FrameStats, make_initial_state, run_sequence
from msckf_tpu_torch.filter.streamed import run_batched_streamed, run_sequence_streamed
from msckf_tpu_torch.models.frontend import extract_sequence_features
from msckf_tpu_torch.models.xfeat import (
    XFeatModel, detect_and_compute, init_params, load_xfeat_checkpoint, load_xfeat_npz,
)
from msckf_tpu_torch.ops.device import resolve_device
from msckf_tpu_torch.parallel import multihost as mh
from msckf_tpu_torch.parallel.batched import batched_initial_state, batched_run_sequence
from msckf_tpu_torch.pipeline import run_sequence_images
from msckf_tpu_torch.utils.consistency import consistency_report
from msckf_tpu_torch.utils import viz
from msckf_tpu_torch.utils.metrics import compute_metrics, results_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP_K = 300


def _load_sequence(args, dev):
    """(imu_ts, gyro, acc, cam_ticks, kps, descs, scores, gt_R, gt_t,
    image_paths, cfg_overrides, images): image_paths is None for the
    in-memory and synthetic sources; cfg_overrides carries the source's
    camera. ``images`` is a (C, H, W) float32 array when the image-in
    pipeline runs (``--frontend fused`` on an image source; kps, descs and
    scores are None then), else None."""
    fused = args.frontend == "fused"
    a_nd, g_nd, a_rw, g_rw = NOISE_PRESETS[args.noise_level]
    if args.source == "rendered":
        # ray-traced textured-plane sequence through the image front-end
        gen_kwargs = dict(sigma_acc=a_nd, sigma_gyro=g_nd) if args.gen_noise == "preset" else {}
        # --sequence boxes: the oblique camera over out-of-plane textured
        # boxes; otherwise the flat plane
        gen = generate_rendered_boxes if args.sequence == "boxes" else generate_rendered_circle
        seq = gen(rng=np.random.default_rng(42), n_ticks=min(args.max_frames, 4800),
                  **gen_kwargs)
        H, W = seq.images.shape[1:]
        overrides = dict(
            R_WC=tuple(map(tuple, seq.R_WC_extrinsic.tolist())),
            K=((180.0, 0.0, W / 2.0), (0.0, 180.0, H / 2.0), (0.0, 0.0, 1.0)),
            width=W, height=H,
        )
        if fused:
            return (seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                    None, None, None, seq.poses_R, seq.poses_t, None, overrides,
                    seq.images.astype(np.float32))
        model = _xfeat_model(args, dev)
        kps, descs, scores = [], [], []
        for img in seq.images:
            k, d, s, v = (t.cpu().numpy() for t in detect_and_compute(
                model, torch.as_tensor(img, device=dev), top_k=TOP_K,
                refine_subpix=args.refine_subpix))
            kps.append(k[v])
            descs.append(d[v])
            scores.append(s[v])
        return (seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                kps, descs, scores, seq.poses_R, seq.poses_t, None, overrides, None)

    # probe the dataset's marker file, not the directory: --save_results
    # creates {data_root}/{source}/{sequence}/..._noise/ for its outputs
    if args.source == "synthetic" and not os.path.isfile(
            f"{args.data_root}/synthetic/{args.sequence}/transforms_gt.csv"):
        # no dataset on disk: generate the preset in memory. --gen_noise
        # preset drives the generated IMU noise from the noise preset
        gen_kwargs = {}
        if args.gen_noise == "preset":
            gen_kwargs = dict(sigma_acc=a_nd, sigma_gyro=g_nd, sigma_ba=a_rw, sigma_bg=g_rw)
        gen = generate_classic_sequence if args.sequence == "classic" else generate_circle_sequence
        seq = gen(rng=np.random.default_rng(42), **gen_kwargs)
        return (seq.timestamps, seq.imu_gyro, seq.imu_acc, seq.cam_frame_ticks,
                seq.cam_keypoints, seq.cam_descriptors, seq.cam_scores,
                seq.poses_R, seq.poses_t, None, {}, None)

    if args.source in ("tartanair", "peringlab"):
        # the IMU and ground truth from the raw trajectory, with the preset's
        # noise
        generate_photorealistic(
            args.source, f"{args.data_root}/{args.source}/{args.sequence}",
            accelerometer_noise_density=a_nd, gyroscope_noise_density=g_nd,
            accelerometer_random_walk=a_rw, gyroscope_random_walk=g_rw,
        )

    p = parsing.Parser(args.source, args.sequence, base_path=args.data_root, gt=False)
    imu_ts, gyro, acc = parsing.imu_arrays(p.extract_imu())
    _, gt_R, gt_t = parsing.gt_trajectory_arrays(p.extract_gt_trajectory())
    cams = p.extract_images()
    matched = match_camera_ticks(imu_ts, cams["timestamp"])
    cam_ticks = np.concatenate([[0], matched])  # frame 0 placeholder (skipped)
    n = len(cam_ticks)
    image_paths = None
    kps, descs, scores = [], [], []
    if args.source == "synthetic":
        for path in cams["image_path"]:
            k, d, s = p.extract_synthetic_camera_measurements(path)
            kps.append(k)
            descs.append(d)
            scores.append(s)
    elif fused:
        # the rasters as OpenCV's IMREAD_GRAYSCALE reads them; the CNN runs
        # on the device inside the image-in pipeline
        image_paths = list(cams["image_path"])[:n]
        images = np.stack([imageio.imread_grayscale(q).astype(np.float32) for q in image_paths])
        return (imu_ts, gyro, acc, cam_ticks, None, None, None, gt_R, gt_t, image_paths, {},
                images)
    else:
        image_paths = list(cams["image_path"])
        kps, descs, scores = extract_sequence_features(
            image_paths, top_k=TOP_K, model=_xfeat_model(args, dev),
            refine_subpix=args.refine_subpix, device=dev)
    return (imu_ts, gyro, acc, cam_ticks, kps[:n], descs[:n], scores[:n],
            gt_R, gt_t, image_paths[:n] if image_paths else None, {}, None)


def _xfeat_model(args, dev):
    """The XFeat model: --xfeat_weights (an .npz of the JAX package's
    trainer or an upstream .pt state_dict), else the repository's
    weights/xfeat_selfsup.npz, else random weights with a loud warning."""
    path = args.xfeat_weights
    if not path:
        default = os.path.join(REPO, "weights", "xfeat_selfsup.npz")
        path = default if os.path.exists(default) else ""
    if not path:
        print(
            "WARNING: no XFeat weights found (weights/xfeat_selfsup.npz "
            "missing, --xfeat_weights not given) — the CNN runs with random "
            "weights; real-image accuracy is meaningless"
        )
        return init_params(torch.Generator().manual_seed(0), device=dev)
    if path.endswith(".pt"):
        print(f"XFeat weights: upstream checkpoint {path}")
        model = XFeatModel()
        model.load_state_dict(load_xfeat_checkpoint(path))
        return model.to(dev).eval()
    print(f"XFeat weights: {path}")
    return load_xfeat_npz(path, device=dev)


def _dataset_config(args, cfg, kps, descs):
    """Dataset-derived configuration: camera intrinsics from
    ``{data_root}/{source}/camera_info.csv`` (a warning where a dataset
    source lacks it), buffer capacities sized to the
    sequence (``suggest_capacities``; the overflow warning after the run
    keeps this honest), descriptor width from the data, padded to a
    multiple of 8 (zero padding leaves cosine similarity unchanged)."""
    overrides = {}
    info = parsing.read_camera_info(args.data_root, args.source)
    if info is not None:
        overrides.update(info)
        print(
            f"camera_info.csv: K = [fx {info['K'][0][0]}, fy {info['K'][1][1]}, "
            f"px {info['K'][0][2]}, py {info['K'][1][2]}], "
            f"{info['width']}x{info['height']}"
        )
    elif args.source not in ("synthetic", "rendered"):
        print(
            f"WARNING: {args.data_root}/{args.source}/camera_info.csv not found; "
            f"using default intrinsics (fx {cfg.K[0][0]}) — metrics will be "
            "wrong if the dataset camera differs"
        )
    caps = suggest_capacities(kps, max_camera_states=cfg.max_camera_states)
    dd = max((int(np.asarray(d).shape[1]) for d in descs if len(d)), default=cfg.desc_dim)
    overrides.update(
        f_max=caps["f_max"],
        k_max=caps["k_max"],
        u_max=max(caps["u_max"], 48),
        m_max=caps["m_max"],
        n_cam_slots=caps["n_cam_slots"],
        desc_dim=-(-dd // 8) * 8,
    )
    return dataclasses.replace(cfg, **overrides)


def _check_overflow(cfg, final) -> dict:
    """Capacity-overflow diagnostics, with a loud warning when any fixed
    buffer was exceeded."""
    diag = {
        k: int(getattr(final.diag, k))
        for k in (
            "n_homography_rejected", "n_epipolar_rejected", "n_gating_rejected",
            "n_track_overflow", "n_update_overflow",
        )
    }
    if diag["n_track_overflow"] or diag["n_update_overflow"]:
        print(
            "WARNING: capacity overflow — "
            f"{diag['n_track_overflow']} track spawns dropped (f_max={cfg.f_max}), "
            f"{diag['n_update_overflow']} update features skipped (u_max={cfg.u_max}). "
            "Re-run with larger capacities; accuracy is degraded."
        )
    return diag


def _save_debug_images(out_dir, cfg, kps, scores, descs, image_paths=None):
    """--log_images: per-frame keypoint overlays (radius ~ score) on the
    frame's raster (on the camera canvas for a source without rasters),
    each frame after the first beside the previous one with
    their mutual matches (``draw_matches``: the homography inliers and the
    previous frame's warped corners); where no homography is found, the
    matches are drawn as lines to the previous frame's keypoints."""
    try:
        import cv2
    except ImportError:
        print("--log_images: cv2 unavailable, skipping")
        return
    from msckf_tpu_torch.models.frontend import FeatureExtractor, draw_matches

    os.makedirs(out_dir, exist_ok=True)
    matcher = FeatureExtractor.__new__(FeatureExtractor)  # the matcher only
    prev = None
    for j in range(len(kps)):
        kp = np.asarray(kps[j])
        if image_paths is not None and j < len(image_paths):
            img = cv2.imread(image_paths[j])
            if img is None:
                continue
        else:
            img = np.full((cfg.height, cfg.width, 3), 32, np.uint8)
        s = np.asarray(scores[j])
        smax = s.max() if len(s) and s.max() > 0 else 1.0
        for (x, y), sc in zip(kp, s):
            if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
                cv2.circle(img, (int(x), int(y)), 2 + int(3 * sc / smax), (0, 255, 0), 1)
        out = img
        if prev is not None and len(kp) and len(kps[j - 1]):
            i1, i2 = matcher.match(np.asarray(descs[j - 1]), np.asarray(descs[j]),
                                   min_cossim=cfg.min_cosine_similarity)
            p0 = np.asarray(kps[j - 1])
            try:
                out = draw_matches(prev, p0[i1], img, kp[i2])
            except ValueError:  # too few matches, or no homography
                out = img.copy()
                for a, b in zip(i1, i2):
                    cv2.line(out, (int(p0[a][0]), int(p0[a][1])),
                             (int(kp[b][0]), int(kp[b][1])), (255, 128, 0), 1)
        cv2.imwrite(f"{out_dir}/{j:05d}.png", out)
        prev = img
    print(f"debug images written to {out_dir}")


def _fence(dev):
    """Wait for the device (the end of a timed region)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(run, dev, **timed_kwargs):
    """A warm-up run on the GPU (the kernels build and the device's caches
    fill; the CPU has nothing to warm, and its warm-up seconds are 0), then
    a timed run given ``timed_kwargs``. Returns (the timed run's result,
    warm-up seconds, timed seconds)."""
    warm_s = 0.0
    if dev.type == "cuda":
        t0 = time.perf_counter()
        run()
        _fence(dev)
        warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = run(**timed_kwargs)
    _fence(dev)
    return res, warm_s, time.perf_counter() - t0


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run the MSCKF VIO (PyTorch port) on a dataset")
    ap.add_argument("--source", default="synthetic",
                    choices=["synthetic", "rendered", "peringlab", "tartanair"])
    ap.add_argument("--sequence", default="circle")
    ap.add_argument("--max_frames", type=int, default=2400)
    ap.add_argument("--noise_level", default="mid", choices=["low", "mid", "high"])
    ap.add_argument("--save_results", action="store_true")
    ap.add_argument("--log_images", action="store_true")
    ap.add_argument("--data_root", default="./data")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument(
        "--device", default="cuda",
        help="torch device to run on; 'cpu' runs the kernels' plain PyTorch versions",
    )
    ap.add_argument(
        "--xfeat_weights", default="",
        help="XFeat weights: .npz (self-supervised trainer) or upstream .pt; "
        "defaults to weights/xfeat_selfsup.npz when present",
    )
    ap.add_argument(
        "--noise_input", default="density", choices=["density", "discrete"],
        help="'density': preset numbers are continuous densities (the "
        "reference's literal behavior). 'discrete': they are per-sample "
        "sigmas at the IMU rate; the filter converts internally "
        "(MSCKFConfig.noise_input_rate)",
    )
    ap.add_argument(
        "--gen_noise", default="default", choices=["default", "preset"],
        help="synthetic in-memory source: 'preset' drives the generated IMU "
        "noise from --noise_level; 'default' keeps the synthetic script's "
        "fixed noise",
    )
    ap.add_argument(
        "--correction_dtype", default="",
        choices=["", "float64", "compensated", "none"],
        help="precision island of the EKF correction chain "
        "(MSCKFConfig.correction_dtype). Default: the config default "
        "(float64). 'none': the filter's dtype. 'compensated': double-word "
        "float32 (ops/compensated.py) for a float32 filter",
    )
    ap.add_argument("--only_imu", action="store_true")
    ap.add_argument(
        "--frontend", default="fused", choices=["fused", "host"],
        help="image sources (rendered/tartanair/peringlab): 'fused' runs the "
        "XFeat CNN over the image stack on the device inside the image-in "
        "pipeline; 'host' extracts features frame by frame first (needed by "
        "--stream_chunk and --log_images)",
    )
    ap.add_argument(
        "--refine_subpix", action="store_true",
        help="subpixel (3x3 quadratic) refinement of XFeat keypoint "
        "coordinates before they enter the filter",
    )
    ap.add_argument(
        "--prune_path", default="", choices=["", "cond", "masked"],
        help="window-saturation prune (MSCKFConfig.prune_path): 'cond' = a "
        "host-side branch (default), 'masked' = the branchless masked-victim "
        "form",
    )
    ap.add_argument(
        "--gain_solver", default="", choices=["", "lu", "ns", "chol"],
        help="unbatched correction solve (MSCKFConfig.gain_solver): 'lu' "
        "(default), 'ns' = Newton-Schulz, 'chol' = SPD Cholesky (both with "
        "the residual-gated LU)",
    )
    ap.add_argument(
        "--rerun_live", action="store_true",
        help="stream telemetry to the Rerun viewer live during the run (per "
        "fetched chunk; requires --stream_chunk and rerun-sdk)",
    )
    ap.add_argument(
        "--stream_chunk", type=int, default=0,
        help="stream the sequence through the filter in chunks of N camera "
        "frames (double-buffered uploads; bounds device memory for sequences "
        "larger than it). 0 = upload the whole stream.",
    )
    ap.add_argument(
        "--batch", type=int, default=0,
        help="filter N independent noise realizations of the circle at once "
        "(torch.func.vmap on one device, or one rank a card under torchrun) and "
        "report per-sequence errors",
    )
    args = ap.parse_args(argv)
    if args.log_images and args.frontend == "fused":
        # the overlays need host-side features
        print("--log_images: switching to --frontend host (overlays need "
              "host-side features)")
        args.frontend = "host"
    dev = resolve_device(args.device)

    a_nd, g_nd, a_rw, g_rw = NOISE_PRESETS[args.noise_level]
    cfg = reference_experiment_config(
        dtype=args.dtype,
        only_imu=args.only_imu,
        accelerometer_noise_density=a_nd,
        gyroscope_noise_density=g_nd,
        accelerometer_random_walk=a_rw,
        gyroscope_random_walk=g_rw,
        # --noise_input discrete: the presets are per-sample sigmas at the
        # reference's ~200 Hz IMU rate
        noise_input_rate=200.0 if args.noise_input == "discrete" else 0.0,
        **({"correction_dtype": args.correction_dtype} if args.correction_dtype else {}),
        **({"prune_path": args.prune_path} if args.prune_path else {}),
        **({"gain_solver": args.gain_solver} if args.gain_solver else {}),
    )

    if args.batch > 0:
        return _run_batched(args, cfg, dev)

    (imu_ts, gyro, acc, cam_ticks, kps, descs, scores, gt_R, gt_t,
     image_paths, src_overrides, images) = _load_sequence(args, dev)
    if images is not None:
        # the CNN's fixed top-k output sizes the buffers; XFeat's
        # descriptors are 64-d
        cfg = _dataset_config(args, cfg, [np.zeros((TOP_K, 2))], [np.zeros((TOP_K, 64))])
    else:
        cfg = _dataset_config(args, cfg, kps, descs)
    if src_overrides:
        cfg = dataclasses.replace(cfg, **src_overrides)

    if args.rerun_live and not args.stream_chunk:
        print("--rerun_live requires --stream_chunk (live = per fetched "
              "chunk); ignoring")
    live_cb = {}
    if images is not None:
        if args.stream_chunk:
            print("--stream_chunk is not supported with --frontend fused; ignoring "
                  "(use --frontend host to stream)")
        stream = build_image_stream(cfg, imu_ts, gyro, acc, cam_ticks,
                                    max_ticks=args.max_frames)
        std = to_device(stream, cfg, device=dev)
        imgs = torch.as_tensor(images[stream.proc_cam_idx], device=dev)
        model = _xfeat_model(args, dev)

        def run():
            stats = FrameStats()
            state = make_initial_state(cfg, std.R_init, device=dev)
            return run_sequence_images(cfg, model, state, std.prefix, std.frames, imgs,
                                       top_k=TOP_K, refine_subpix=args.refine_subpix,
                                       device=dev, stats=stats), stats
    else:
        stream = build_stream(cfg, imu_ts, gyro, acc, cam_ticks, kps, descs, scores,
                              max_ticks=args.max_frames)
        if args.stream_chunk:
            # host-resident stream, two chunks on the device at a time; the
            # timed run logs each fetched chunk live with --rerun_live
            if args.rerun_live:
                if viz.HAVE_RERUN:
                    live = viz.LiveRerunStream(gt_R, gt_t, spawn=True)
                    live_cb = dict(on_prefix=live.consume,
                                   on_chunk=lambda start, out: live.consume(out))
                else:
                    print("rerun-sdk not installed; --rerun_live ignored")

            def run(**live):
                stats = FrameStats()
                state = make_initial_state(cfg, stream.R_init, device=dev)
                return run_sequence_streamed(cfg, state, stream.prefix, stream.frames,
                                             chunk_frames=args.stream_chunk, device=dev,
                                             assume_camera=True, stats=stats, **live), stats
        else:
            std = to_device(stream, cfg, device=dev)

            def run():
                stats = FrameStats()
                state = make_initial_state(cfg, std.R_init, device=dev)
                return run_sequence(cfg, state, std.prefix, std.frames, assume_camera=True,
                                    device=dev, stats=stats), stats

    ((final, pre_out, fr_out), stats), warm_s, run_s = _timed(run, dev, **live_cb)
    n_frames, block = stream.frames["imu_ts"].shape

    def flat(name):
        a = _host(getattr(pre_out, name))
        b = _host(getattr(fr_out, name))
        return np.concatenate([a, b.reshape((-1,) + b.shape[2:])], axis=0)

    valid = flat("valid").astype(bool)
    est_R = flat("R_WI")[valid]
    est_t = flat("p_WI")[valid]
    sig_rot = flat("sigma_rot")[valid]
    sig_pos = flat("sigma_pos")[valid]
    T = len(est_t)
    gt_R, gt_t = gt_R[:T], gt_t[:T]

    m = compute_metrics(gt_R, gt_t, est_R, est_t, sig_rot, sig_pos)
    prof = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "warmup_s": round(warm_s, 3),
        "sequence_s": round(run_s, 6),
        "ticks": T,
        "imu_steps_per_s": round(T / run_s, 1),
        "camera_updates_per_s": round(n_frames / run_s, 1),
        "host_syncs_per_frame": round(stats.host_syncs / max(stats.frames, 1), 3),
    }
    report = results_report(m, prof)
    cons = consistency_report(gt_R, gt_t, est_R, est_t, sig_rot, sig_pos)
    report += " - Consistency:\n"
    report += f"   - ATE within 3-sigma:  {cons['ate_within_3sigma']:.3f}\n"
    report += f"   - AOE within 3-sigma:  {cons['aoe_within_3sigma']:.3f}\n"
    report += (
        f"   - NEES median: {cons['nees_median']:.2f} "
        f"(chi2(6) {cons['nees_lo']:.2f}..{cons['nees_hi']:.2f}, "
        f"in-bounds {cons['nees_within_bounds']:.3f})\n"
    )
    print(report)
    diag = _check_overflow(cfg, final)

    out_dir = f"{args.data_root}/{args.source}/{args.sequence}/{args.noise_level}_noise"
    if args.log_images:
        _save_debug_images(f"{out_dir}/debug_images", cfg, kps, scores, descs, image_paths)
    if args.save_results:
        os.makedirs(out_dir, exist_ok=True)
        with open(f"{out_dir}/results.txt", "w") as f:
            f.write(report)
        _save_plots(m, out_dir)
        # the .rrd recording, where rerun-sdk is installed
        if viz.HAVE_RERUN:
            viz.stream_to_rerun(gt_t, est_R, est_t, m, n_tracks=flat("n_tracks")[valid],
                                n_cams=flat("n_cams")[valid],
                                save_path=f"{out_dir}/recording.rrd")
            print(f"rerun recording written to {out_dir}/recording.rrd")
        print(f"results written to {out_dir}")
    # for callers and tests: the resolved config, the diagnostics, the timed
    # run's counts and final state, the stream's (frames, ticks per frame,
    # prefix ticks), the consistency figures and the profiling numbers
    m.cfg = cfg
    m.diag = diag
    m.stats = stats
    m.final = final
    m.blocks = (n_frames, block, stream.prefix["imu_ts"].shape[0])
    m.consistency = cons
    m.profiling = prof
    return m


class BatchedErrors(list):
    """The final position error of each sequence of a ``--batch`` run (what
    the JAX runner returns; every rank's under ``torchrun``), carrying the
    run's ``cfg``, ``final`` states (this process's rows), ``blocks`` as in
    ``main`` and timed ``seconds`` (the slowest rank's)."""


def _run_batched(args, cfg, dev):
    """N noise realizations (seeds 100, 101, ...) of the synthetic circle
    through the batched loop: in one process on ``dev``, or under
    ``torchrun`` (``WORLD_SIZE`` > 1) one rank a card, each filtering its
    own rows (``parallel/multihost.py``), rank 0 reporting. A process drives
    one card: the loop is bound by the host's issue rate, so one process
    splitting the batch over several cards would run no faster than one
    card (PERF.md). Per-sequence final errors and aggregate throughput."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return _batched_rows(args, cfg, dev, None, "")
    # NCCL refuses ranks that share a card: such ranks meet over gloo, and
    # the report names the backend
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    shared = dev.type == "cuda" and per_host > torch.cuda.device_count()
    mh.init_distributed(backend="gloo" if shared else None, device=dev)
    try:
        gmesh = mh.global_data_mesh(device=dev)
        return _batched_rows(args, cfg, mh.rank_device(gmesh), gmesh,
                             f", backend {torch.distributed.get_backend()}")
    finally:
        torch.distributed.destroy_process_group()


def _batched_rows(args, cfg, dev, gmesh, backend):
    """``_run_batched`` on ``dev``: all N rows in one process (``gmesh``
    None), or this rank's rows, gathered over ``gmesh``."""
    # buffers sized for the synthetic circle (zero overflow)
    cfg = dataclasses.replace(cfg, f_max=192, u_max=32, k_max=256, desc_dim=16)
    B = args.batch
    start, per = (0, B) if gmesh is None else mh.local_batch_slice(B)
    seqs = [generate_circle_sequence(rng=np.random.default_rng(100 + b))
            for b in range(start, start + per)]
    streams = [
        build_stream(cfg, s.timestamps, s.imu_gyro, s.imu_acc, s.cam_frame_ticks,
                     s.cam_keypoints, s.cam_descriptors, s.cam_scores,
                     max_ticks=args.max_frames)
        for s in seqs
    ]

    def stack(dicts):
        return {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}

    prefix = stack([s.prefix for s in streams])
    frames = stack([s.frames for s in streams])
    R_inits = np.stack([s.R_init for s in streams])

    if args.stream_chunk:
        # trajectories wide and sequences long: the batch streamed in chunks
        def run():
            states = batched_initial_state(cfg, per, R_init=R_inits, device=dev)
            return run_batched_streamed(cfg, states, prefix, frames,
                                        chunk_frames=args.stream_chunk, device=dev,
                                        assume_camera=True)
    else:
        std = to_device(streams[0]._replace(prefix=prefix, frames=frames), cfg, device=dev)

        def run():
            states = batched_initial_state(cfg, per, R_init=R_inits, device=dev)
            return batched_run_sequence(cfg, states, std.prefix, std.frames,
                                        assume_camera=True, device=dev)

    (final, _, _), warm_s, run_s = _timed(run, dev)
    p_final = final.imu.p_WI.double().cpu().numpy()
    errs = np.array([np.linalg.norm(p_final[b] - seqs[b].poses_t[streams[b].n_ticks - 1])
                     for b in range(per)])
    if gmesh is not None:
        # every rank's errors and the slowest rank's times, in rank order
        errs = mh.gather_global(torch.as_tensor(errs, device=dev), gmesh).cpu().numpy()
        warm_s, run_s = mh.gather_global(torch.tensor([[warm_s, run_s]], dtype=torch.float64,
                                                      device=dev), gmesh).amax(0).tolist()
    errs = BatchedErrors(errs.tolist())
    n_frames, block = frames["imu_ts"].shape[1:3]
    if gmesh is None or torch.distributed.get_rank() == 0:
        n_dev, where = (1, str(dev)) if gmesh is None else (gmesh.size(), "one a rank")
        print(f"batched VIO: {B} sequences on {n_dev} device(s) ({where}{backend})")
        print(f" - warm-up: {warm_s:.1f} s; run: {run_s:.4f} s")
        print(f" - aggregate camera updates/s: {B * n_frames / run_s:.0f}")
        print(f" - final position errors [m]: {np.round(errs, 4).tolist()}")
    errs.cfg = cfg
    errs.final = final
    errs.blocks = (n_frames, block, prefix["imu_ts"].shape[1])
    errs.seconds = run_s
    return errs


def _save_plots(m, out_dir):
    """RTE/ROE and ATE/AOE figures (when matplotlib is installed)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(2, 1, figsize=(6.6, 6), sharex="col")
    ax[0].plot(m.rte, linewidth=1.5)
    ax[0].set_title("Relative Translation Error %")
    ax[0].grid(True, linewidth=0.2)
    ax[1].plot(m.roe, linewidth=1.5)
    ax[1].set_title("Relative Orientation Error %")
    ax[1].set_xlabel("Frame")
    ax[1].grid(True, linewidth=0.2)
    fig.tight_layout()
    fig.savefig(f"{out_dir}/RTE_ROE.png", dpi=150)
    plt.close(fig)

    fig, ax = plt.subplots(2, 3, figsize=(18, 6), sharey="row", sharex="col")
    names = ["x [m]", "y [m]", "z [m]"]
    for i in range(3):
        ax[0, i].plot(m.ate[:, i], linewidth=1.5)
        ax[0, i].plot(m.ate_bounds[:, i], "--", linewidth=0.9)
        ax[0, i].plot(-m.ate_bounds[:, i], "--", linewidth=0.9)
        ax[0, i].set_title(f"Absolute Translation Error {names[i]}")
        ax[0, i].grid(True, linewidth=0.2)
    rnames = ["roll", "pitch", "yaw"]
    for i in range(3):
        ax[1, i].plot(m.aoe[:, i], linewidth=1.5)
        ax[1, i].plot(m.aoe_bounds[:, i], "--", linewidth=0.9)
        ax[1, i].plot(-m.aoe_bounds[:, i], "--", linewidth=0.9)
        ax[1, i].set_title(f"Absolute Orientation Error {rnames[i]} [rad]")
        ax[1, i].set_xlabel("Frame")
        ax[1, i].grid(True, linewidth=0.2)
    fig.tight_layout()
    fig.savefig(f"{out_dir}/ATE_AOE.png", dpi=150)
    plt.close(fig)


if __name__ == "__main__":
    main()
