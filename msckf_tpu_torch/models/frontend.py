"""Feature front-end: extraction and matching (port of
``msckf_tpu/models/frontend.py``).

``FeatureExtractor`` wraps ``detect_and_compute`` (top-k keypoints,
descriptors and scores of one image, invalid slots dropped) and upstream
XFeat's mutual nearest-neighbour cosine matching; ``match_frames`` matches
two raw frames. ``load_image_grayscale`` (and so
``extract_sequence_features``) reads a PNG with ``data/imageio.py``, without
OpenCV; ``draw_matches`` imports OpenCV inside the function, so the module
imports without it. The filter's own track matching
lives on the device in ``msckf_tpu_torch/filter/matching.py``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from msckf_tpu_torch.data import imageio
from msckf_tpu_torch.models.xfeat import (
    XFeatModel, batched_detect_and_compute, detect_and_compute, init_params,
)
from msckf_tpu_torch.ops.device import resolve_device


class FeatureExtractor:
    """XFeat-based extractor on ``device`` (the GPU unless ``device="cpu"``).

    model: an ``XFeatModel`` (random weights from generator seed 0 unless
    given, e.g. by ``models/xfeat.py::load_xfeat_npz``).
    """

    def __init__(self, model: XFeatModel | None = None, top_k: int = 300,
                 refine_subpix: bool = False, device=None):
        self.device = resolve_device(device)
        if model is None:
            model = init_params(torch.Generator().manual_seed(0), device=self.device)
        self.model = model.to(self.device).eval()
        self.top_k = top_k
        self.refine_subpix = refine_subpix

    def extract_features(self, image: np.ndarray, top_k: int | None = None):
        """(keypoints, descriptors, scores) of one image as numpy arrays,
        invalid slots dropped."""
        img = torch.as_tensor(np.asarray(image, dtype=np.float32), device=self.device)
        kpts, desc, scores, valid = detect_and_compute(
            self.model, img, top_k=self.top_k if top_k is None else top_k,
            refine_subpix=self.refine_subpix)
        v = valid.cpu().numpy()
        return kpts.cpu().numpy()[v], desc.cpu().numpy()[v], scores.cpu().numpy()[v]

    def match(self, desc1: np.ndarray, desc2: np.ndarray, min_cossim: float = 0.82):
        """Mutual-NN cosine matching, upstream ``XFeat.match`` semantics.
        Returns (idxs1, idxs2)."""
        sim = np.asarray(desc1) @ np.asarray(desc2).T
        m12 = sim.argmax(axis=1)
        m21 = sim.argmax(axis=0)
        mutual = m21[m12] == np.arange(len(desc1))
        keep = mutual & (sim.max(axis=1) > min_cossim) if min_cossim > 0 else mutual
        return np.arange(len(desc1))[keep], m12[keep]


def match_frames(extractor: FeatureExtractor, kp1, desc1, scores1, kp2, desc2, scores2):
    """Match two raw frames, returning aligned (kp, desc, score) pairs
    (min_cossim upstream's 0.82)."""
    i1, i2 = extractor.match(desc1, desc2, min_cossim=0.82)
    out1 = (np.asarray(kp1)[i1], np.asarray(desc1)[i1], np.asarray(scores1)[i1])
    out2 = (np.asarray(kp2)[i2], np.asarray(desc2)[i2], np.asarray(scores2)[i2])
    return out1, out2


def draw_matches(image1: np.ndarray, keypoints1: np.ndarray,
                 image2: np.ndarray, keypoints2: np.ndarray) -> np.ndarray:
    """Homography-RANSAC debug picture: the inlier matches, and the corners
    of image1 warped onto image2. Raises ``ValueError`` for fewer than four
    matches or when no homography is found."""
    import cv2

    if len(keypoints1) < 4:
        raise ValueError(f"a homography needs 4 matches, got {len(keypoints1)}")
    H, mask = cv2.findHomography(
        keypoints1, keypoints2, cv2.USAC_MAGSAC, 3.5, maxIters=1000, confidence=0.999
    )
    if H is None:
        raise ValueError("no homography found")
    mask = mask.flatten()
    h, w = image1.shape[:2]
    corners = np.array(
        [[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], dtype=np.float32
    ).reshape(-1, 1, 2)
    warped = cv2.perspectiveTransform(corners, H)
    img2 = image2.copy()
    for i in range(len(warped)):
        a = tuple(warped[i - 1][0].astype(int))
        b = tuple(warped[i][0].astype(int))
        cv2.line(img2, a, b, (0, 0, 255), 4)
    kp1 = [cv2.KeyPoint(float(p[0]), float(p[1]), 5) for p in keypoints1]
    kp2 = [cv2.KeyPoint(float(p[0]), float(p[1]), 5) for p in keypoints2]
    matches = [cv2.DMatch(i, i, 0) for i in range(len(mask)) if mask[i]]
    return cv2.drawMatches(
        image1, kp1, img2, kp2, matches, None, matchColor=(0, 255, 0), flags=2
    )


def load_image_grayscale(path: str) -> np.ndarray:
    """An image file as a float32 (H, W) grayscale array in [0, 255], as
    OpenCV's ``cvtColor(imread(path), COLOR_BGR2GRAY)`` gives it."""
    return imageio.imread_color_gray(path).astype(np.float32)


def extract_sequence_features(paths: Sequence[str], top_k: int = 300,
                              model: XFeatModel | None = None, batch: int = 8,
                              refine_subpix: bool = False, device=None):
    """(keypoints, descriptors, scores) lists, one entry per image file, on
    ``device`` (the GPU unless ``device="cpu"``).

    Same-shaped frames run as batched CNN calls of ``batch`` frames, the
    last chunk padded with copies of its last frame (when the sequence has
    more than one chunk); mixed shapes run frame by frame. ``model``: an
    ``XFeatModel`` (random weights from generator seed 0 when None, with a
    warning, since real-image accuracy is then meaningless).
    """
    dev = resolve_device(device)
    imgs = [load_image_grayscale(p) for p in paths]
    kps, descs, scores = [], [], []
    if len({im.shape for im in imgs}) == 1 and len(imgs) > 1:
        if model is None:
            print(
                "WARNING: extract_sequence_features called without XFeat "
                "weights — the CNN runs with random weights; real-image "
                "accuracy is meaningless"
            )
            model = init_params(torch.Generator().manual_seed(0), device=dev)
        for i in range(0, len(imgs), batch):
            chunk = imgs[i : i + batch]
            n = len(chunk)
            while len(chunk) < batch and i > 0:  # pad the last chunk
                chunk = chunk + [chunk[-1]]
            arr = torch.as_tensor(np.stack(chunk, axis=0), device=dev)
            k, d, s, v = (t.cpu().numpy() for t in batched_detect_and_compute(
                model, arr, top_k=top_k, refine_subpix=refine_subpix))
            for j in range(n):
                kps.append(k[j][v[j]])
                descs.append(d[j][v[j]])
                scores.append(s[j][v[j]])
        return kps, descs, scores
    fx = FeatureExtractor(model=model, top_k=top_k, refine_subpix=refine_subpix, device=dev)
    for im in imgs:
        k, d, s = fx.extract_features(im)
        kps.append(k)
        descs.append(d)
        scores.append(s)
    return kps, descs, scores
