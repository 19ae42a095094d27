"""The front-end's image-file helpers of the PyTorch port against the JAX
package's: ``load_image_grayscale``, ``extract_sequence_features`` and
``draw_matches``.

Grayscale PNGs of 96 x 128 (random textures of the JAX package's
``models/selfsup.py::random_texture``) written with OpenCV; the committed
weights (``weights/xfeat_selfsup.npz``) in both packages. Keypoints equal,
scores within 1e-5 and descriptors within 1e-4 (tests/test_torch_xfeat.py's
tolerances), on the batched path with its padded last chunk and on the
per-frame path of mixed shapes; the match picture equal pixel for pixel.
"""

from pathlib import Path

import cv2
import numpy as np
import pytest

from msckf_tpu.models import frontend as jfe
from msckf_tpu.models.selfsup import random_texture
from msckf_tpu.models.train_xfeat import load_npz_params as jax_load_npz_params

from msckf_tpu_torch.models import frontend as tfe
from msckf_tpu_torch.models.xfeat import load_xfeat_npz

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "xfeat_selfsup.npz"


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Three 96 x 128 frames panning over one texture, and a 64 x 96 one."""
    d = tmp_path_factory.mktemp("frames")
    tex = random_texture(np.random.default_rng(5), 160)
    paths = []
    for i, (h, w) in enumerate(((96, 128), (96, 128), (96, 128), (64, 96))):
        p = str(d / f"{i:03d}.png")
        cv2.imwrite(p, np.clip(tex[4 * i:4 * i + h, 6 * i:6 * i + w], 0, 255).astype(np.uint8))
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def models():
    return jax_load_npz_params(str(WEIGHTS)), load_xfeat_npz(str(WEIGHTS), device="cpu")


def test_load_image_grayscale(pngs):
    for p in pngs:
        a, b = tfe.load_image_grayscale(p), jfe.load_image_grayscale(p)
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tfe.load_image_grayscale(str(Path(pngs[0]).with_name("missing.png")))


@pytest.mark.parametrize("which", ["batched", "mixed shapes"])
def test_extract_sequence_features(pngs, models, which):
    paths = pngs[:3] if which == "batched" else pngs
    params, model = models
    got = tfe.extract_sequence_features(paths, top_k=64, model=model, batch=2, device="cpu")
    ref = jfe.extract_sequence_features(paths, top_k=64, params=params, batch=2)
    for (k, d, s), (kj, dj, sj) in zip(zip(*got), zip(*ref)):
        assert len(k) > 20
        np.testing.assert_array_equal(k, np.asarray(kj))
        np.testing.assert_allclose(s, np.asarray(sj), rtol=0, atol=1e-5)
        np.testing.assert_allclose(d, np.asarray(dj), rtol=0, atol=1e-4)
    assert len(got[0]) == len(paths)


def test_draw_matches(pngs, models):
    _, model = models
    kps, descs, _ = tfe.extract_sequence_features(pngs[:2], top_k=128, model=model,
                                                  device="cpu")
    i1, i2 = tfe.FeatureExtractor(model, device="cpu").match(descs[0], descs[1], min_cossim=0.5)
    assert len(i1) >= 8
    img1, img2 = cv2.imread(pngs[0]), cv2.imread(pngs[1])
    k1, k2 = kps[0][i1].astype(np.float32), kps[1][i2].astype(np.float32)
    cv2.setRNGSeed(0)
    got = tfe.draw_matches(img1, k1, img2, k2)
    cv2.setRNGSeed(0)
    ref = jfe.draw_matches(img1, k1, img2, k2)
    assert got.shape == (96, 256, 3)
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="4 matches"):
        tfe.draw_matches(img1, k1[:3], img2, k2[:3])
