"""Frozen front-end evaluation benchmark: the port of
``msckf_tpu/models/frontend_eval.py``.

The evaluation pair set is a committed data artifact
(``weights/frontend_eval_v1.npz``, its SHA-256 pinned by
``tests/test_xfeat_frozen_eval.py``), so a change to the texture or
homography distribution in ``models/selfsup.py`` cannot move the number.

Protocol (v1):
  * pair set: 8 "hard" pairs (full training augmentation: corner perturbation
    0.15, rotation to 0.5 rad, scale 0.8-1.25) and 8 "mild" pairs (0.08 /
    0.1 rad / 0.95-1.05) drawn from ``selfsup.make_batch`` at size 256 with
    ``np.random.default_rng(999)``;
  * metric: mutual-nearest-neighbour cosine matching of
    ``detect_and_compute(top_k=200)`` keypoints; precision = fraction of
    mutual matches whose reprojection through the true homography errs
    < 3 px; reported as the mean over pairs (plus mean matches/pair).

A revision of the benchmark adds a ``frontend_eval_v2.npz`` and reports both;
v1 is never regenerated. The model runs on its own device, in eval mode.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from msckf_tpu_torch.models.selfsup import make_batch
from msckf_tpu_torch.models.xfeat import XFeatModel, detect_and_compute

FIXTURE_V1 = str(Path(__file__).resolve().parents[2] / "weights" / "frontend_eval_v1.npz")
TOP_K = 200
TOL_PX = 3.0

# frozen-generation parameters (provenance; generate_fixture_v1 uses them)
_SEED = 999
_N_PAIRS = 8
_SIZE = 256
_MILD_KW = dict(scale=0.08, max_rot=0.1, scale_range=(0.95, 1.05))


def generate_fixture_v1(path: str = FIXTURE_V1) -> None:
    """One-shot fixture generation, kept for provenance: the committed
    artifact is authoritative, and regenerating after any ``selfsup`` change
    gives a DIFFERENT benchmark, which must become a v2 file instead."""
    hard = make_batch(np.random.default_rng(_SEED), _N_PAIRS, _SIZE)
    mild = make_batch(np.random.default_rng(_SEED), _N_PAIRS, _SIZE, **_MILD_KW)
    np.savez_compressed(
        path,
        hard_img1=hard.img1, hard_img2=hard.img2, hard_H=hard.H,
        mild_img1=mild.img1, mild_img2=mild.img2, mild_H=mild.H,
        top_k=np.int32(TOP_K), tol_px=np.float32(TOL_PX),
    )


def fixture_sha256(path: str = FIXTURE_V1) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _detect(model: XFeatModel, img: np.ndarray, top_k: int):
    dev = next(model.parameters()).device
    out = detect_and_compute(model, torch.as_tensor(np.asarray(img, np.float32), device=dev),
                             top_k=top_k)
    return [t.cpu().numpy() for t in out]


def pair_match_stats(model: XFeatModel, img1, img2, H, top_k: int = TOP_K,
                     tol_px: float = TOL_PX):
    """Mutual-NN match precision for ONE image pair under homography H.

    Returns (precision@tol, n_mutual_matches). The matching protocol is the
    front-end's own (cosine similarity, mutual argmax), evaluated against
    the exact warp ground truth; the matching runs on the host in numpy, as
    in the JAX package."""
    k1, d1, _, v1 = _detect(model, img1, top_k)
    k2, d2, _, v2 = _detect(model, img2, top_k)
    k1, d1 = k1[v1], d1[v1]
    k2, d2 = k2[v2], d2[v2]
    if len(k1) < 8 or len(k2) < 8:
        return 0.0, 0
    sim = d1 @ d2.T
    m12 = sim.argmax(1)
    m21 = sim.argmax(0)
    mutual = m21[m12] == np.arange(len(k1))
    i1 = np.arange(len(k1))[mutual]
    i2 = m12[mutual]
    ph = np.concatenate([k1[i1], np.ones((len(i1), 1))], -1)
    q = ph @ np.asarray(H).T
    proj = q[:, :2] / q[:, 2:3]
    err = np.linalg.norm(proj - k2[i2], axis=-1)
    prec = float(np.mean(err < tol_px)) if len(err) else 0.0
    return prec, int(len(err))


def frozen_match_precision(model: XFeatModel, hard: bool = True, path: str = FIXTURE_V1):
    """THE benchmark number: mean mutual-NN precision@3px over the frozen
    pair set. Returns (precision, mean matches/pair)."""
    with np.load(path) as data:
        pre = "hard" if hard else "mild"
        img1 = data[f"{pre}_img1"].astype(np.float32)
        img2 = data[f"{pre}_img2"].astype(np.float32)
        Hs = data[f"{pre}_H"]
        top_k = int(data["top_k"])
        tol_px = float(data["tol_px"])
    precs, counts = [], []
    for b in range(img1.shape[0]):
        p, n = pair_match_stats(model, img1[b], img2[b], Hs[b], top_k=top_k, tol_px=tol_px)
        precs.append(p)
        counts.append(n)
    return float(np.mean(precs)), float(np.mean(counts))
