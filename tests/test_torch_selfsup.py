"""The port's self-supervised training data against the JAX package's.

``msckf_tpu_torch/models/selfsup.py`` is numpy host code that feeds every
training batch and the frozen benchmark, so every output is held BITWISE to
``msckf_tpu/models/selfsup.py`` for the same ``np.random.Generator`` seed:
each of the four texture kinds, the homographies (default and mild), the
warp, the jitter, the corner teacher and ``make_batch``. The regenerated
frozen fixture is in ``tests/test_torch_frontend_eval.py``.
"""

import dataclasses

import numpy as np
import pytest

from msckf_tpu.models import selfsup as jss

from msckf_tpu_torch.models import selfsup as tss

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZE = 64
MILD = dict(scale=0.08, max_rot=0.1, scale_range=(0.95, 1.05))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _seed_of_kind(kind: int) -> int:
    """The first seed whose generator's first draw picks texture ``kind``."""
    return next(s for s in range(100) if np.random.default_rng(s).integers(0, 4) == kind)


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
def test_random_texture_bitwise(kind):
    seed = _seed_of_kind(kind)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    _same(tss.random_texture(rt, SIZE), jss.random_texture(rj, SIZE))
    # the generators were advanced alike
    assert rt.integers(1 << 30) == rj.integers(1 << 30)


@pytest.mark.parametrize("kw", [{}, MILD], ids=["default", "mild"])
def test_random_homography_bitwise(kw):
    for seed in range(4):
        _same(tss.random_homography(np.random.default_rng(seed), SIZE, **kw),
              jss.random_homography(np.random.default_rng(seed), SIZE, **kw))


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(7)
    img = jss.random_texture(rng, SIZE)
    H = jss.random_homography(rng, SIZE)
    return img, H, jss.warp_image(img, H)


def test_warp_and_jitter_bitwise(pair):
    img, H, warped = pair
    _same(tss.warp_image(img, H), warped)
    _same(tss.warp_image(img, np.linalg.inv(H)), jss.warp_image(img, np.linalg.inv(H)))
    _same(tss.photometric_jitter(np.random.default_rng(1), warped),
          jss.photometric_jitter(np.random.default_rng(1), warped))


def test_corner_teacher_bitwise(pair):
    img, H, warped = pair
    r = tss.shi_tomasi_response(img)
    _same(r, jss.shi_tomasi_response(img))
    for thresh in (0.01, 0.002):
        _same(tss.labels_from_response(r, thresh), jss.labels_from_response(r, thresh))
    _same(tss.corner_labels(warped), jss.corner_labels(warped))
    for a, b in zip(tss.joint_corner_labels(img, warped, H),
                    jss.joint_corner_labels(img, warped, H)):
        _same(a, b)
    # a flat image takes the adaptive threshold's other branch: all dustbin
    flat = np.full((SIZE, SIZE), 100.0, np.float32)
    for a, b in zip(tss.joint_corner_labels(flat, flat, np.eye(3)),
                    jss.joint_corner_labels(flat, flat, np.eye(3))):
        _same(a, b)
        assert (a == 64).all()


@pytest.mark.parametrize("kw", [{}, MILD], ids=["default", "mild"])
def test_make_batch_bitwise(kw):
    got = tss.make_batch(np.random.default_rng(11), 3, SIZE, **kw)
    want = jss.make_batch(np.random.default_rng(11), 3, SIZE, **kw)
    for f in dataclasses.fields(want):
        _same(getattr(got, f.name), getattr(want, f.name))
    assert got.img1.shape == (3, SIZE, SIZE) and got.kp_labels1.shape == (3, SIZE // 8, SIZE // 8)
