"""Feature front-end: extraction and matching (port of
``msckf_tpu/models/frontend.py``).

``FeatureExtractor`` wraps ``detect_and_compute`` (top-k keypoints,
descriptors and scores of one image, invalid slots dropped) and upstream
XFeat's mutual nearest-neighbour cosine matching; ``match_frames`` matches
two raw frames. The filter's own track matching lives on the device in
``msckf_tpu_torch/filter/matching.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from msckf_tpu_torch.models.xfeat import XFeatModel, detect_and_compute, init_params
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
