"""The port's XFeat front-end against the JAX package's.

The committed self-supervised weights (``weights/xfeat_selfsup.npz``, read by
the JAX package's ``load_npz_params``) carried across by
``state_dict_from_flax``; random-texture images from the JAX package's
``models/selfsup.py::random_texture``, on the CPU:

* the backbone against Flax, float32 (XLA's and oneDNN's float32
  convolutions round differently: the largest error seen was 4e-7 of each
  output's scale, held to 1e-5);
* ``keypoint_heatmap``, ``_reliability_fullres`` and ``interpolate_sparse``
  (nearest, bilinear, bicubic) in float64 at 1e-12;
* the top-k against ``lax.top_k`` on arrays full of ties;
* ``detect_and_compute`` on /32 sides, on the resize path and with
  ``refine_subpix``: keypoints equal in every slot, valid or not, scores
  within 1e-5, descriptors within 1e-4; a stack against single calls;
* ``convert_torch_state_dict`` on the upstream layout, and
  ``FeatureExtractor.match``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_tpu.models import xfeat as jxf
from msckf_tpu.models.frontend import FeatureExtractor as JaxExtractor
from msckf_tpu.models.selfsup import random_texture
from msckf_tpu.models.train_xfeat import load_npz_params as jax_load_npz_params

from msckf_tpu_torch.models import xfeat as txf
from msckf_tpu_torch.models.frontend import FeatureExtractor, match_frames

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "xfeat_selfsup.npz"


@pytest.fixture(scope="module")
def jax_params():
    return jax_load_npz_params(str(WEIGHTS))


@pytest.fixture(scope="module")
def model(jax_params):
    m = txf.XFeatModel()
    m.load_state_dict(state_dict := txf.state_dict_from_flax(
        jax.tree.map(np.asarray, jax_params)))
    assert set(state_dict) == set(m.state_dict())
    return m.eval()


def _texture(seed, h, w):
    """A random texture cut to (h, w), float32 in [0, 255]."""
    return np.ascontiguousarray(random_texture(np.random.default_rng(seed), max(h, w))[:h, :w])


@pytest.mark.parametrize("h, w", [(64, 96), (96, 96)])
def test_backbone_matches_flax(jax_params, model, h, w):
    img = _texture(h + w, h, w)
    outs_j = jxf.XFeatModel().apply(jax_params, jnp.asarray(img)[None, :, :, None])
    with torch.no_grad():
        outs_t = model(torch.as_tensor(img)[None, None])
    for name, a, b in zip(("feats", "kp_logits", "heatmap"), outs_j, outs_t):
        a = np.asarray(a).transpose(0, 3, 1, 2)
        assert b.shape == a.shape, name
        err = np.abs(b.numpy() - a).max() / np.abs(a).max()
        assert err <= 1e-5, (name, err)


def test_load_npz_params_matches_the_jax_reader(jax_params):
    ours = txf.load_npz_params(str(WEIGHTS))
    flat_j = jax.tree_util.tree_leaves_with_path(jax_params)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert len(flat_j) == len(flat_t) == 23 * 3 + 4 * 2
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], np.asarray(leaf))
    model = txf.load_xfeat_npz(str(WEIGHTS), device="cpu")
    ref = txf.state_dict_from_flax(ours)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)


def test_keypoint_heatmap_f64():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 65, 3, 4)) * 4.0
    ref = np.asarray(jxf.keypoint_heatmap(jnp.asarray(logits.transpose(0, 2, 3, 1)), temp=0.7))
    got = txf.keypoint_heatmap(torch.as_tensor(logits), temp=0.7).numpy()
    assert got.shape == ref.shape == (2, 24, 32)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("h, w, H, W", [(12, 8, 96, 64), (4, 6, 32, 48)])
def test_reliability_fullres_f64(h, w, H, W):
    rel = np.random.default_rng(h * w).uniform(size=(h, w))
    ref = np.asarray(jxf._reliability_fullres(jnp.asarray(rel), H, W))
    got = txf._reliability_fullres(torch.as_tensor(rel), H, W).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)
    # a leading batch axis gives each map's own result
    both = txf._reliability_fullres(torch.as_tensor(np.stack([rel, 2.0 * rel])), H, W)
    np.testing.assert_allclose(both[1].numpy(), 2.0 * got, rtol=1e-12)


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "bicubic"])
def test_interpolate_sparse_f64(mode):
    rng = np.random.default_rng(3)
    h, w, C, H, W = 12, 16, 5, 96, 128
    grid = rng.normal(size=(h, w, C))
    # positions inside, on the border and past it (zeros padding), and the
    # integer peaks detect_and_compute samples at
    pos = np.concatenate([
        rng.uniform(-4.0, [W + 4.0, H + 4.0], size=(40, 2)),
        rng.integers(0, [W, H], size=(20, 2)).astype(np.float64),
        [[0.0, 0.0], [W - 1.0, H - 1.0], [W - 1.0, 0.0]],
    ])
    ref = np.asarray(jxf.interpolate_sparse(jnp.asarray(grid), jnp.asarray(pos), H, W, mode))
    got = txf.interpolate_sparse(torch.as_tensor(grid), torch.as_tensor(pos), H, W, mode)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-13)
    batched = txf.interpolate_sparse(torch.as_tensor(np.stack([grid, -grid])),
                                     torch.as_tensor(np.stack([pos, pos])), H, W, mode)
    np.testing.assert_array_equal(batched[0].numpy(), got.numpy())
    np.testing.assert_allclose(batched[1].numpy(), -ref, rtol=1e-12, atol=1e-13)


def test_topk_breaks_ties_like_lax_top_k():
    rng = np.random.default_rng(42)
    cases = [
        rng.choice([0.0, 0.25, 0.5, 1.0], size=4096),  # quantized plateaus
        np.full(4096, 0.5),  # all equal
        np.concatenate([np.full(4095, 0.5), [0.9]]),  # one winner at the end
        np.where(rng.uniform(size=5000) < 0.02, rng.uniform(size=5000), -1.0),  # sparse peaks
    ]
    for x in cases:
        for k in (1, 63, 300):
            vj, ij = jax.lax.top_k(jnp.asarray(x, jnp.float32), k)
            vt, it = txf.topk_lowest_index(torch.as_tensor(x, dtype=torch.float32), k)
            np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
            np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    # a batch of rows sorts each row on its own
    xs = np.stack(cases[:3]).astype(np.float32)
    vt, it = txf.topk_lowest_index(torch.as_tensor(xs), 300)
    for row, x in enumerate(xs):
        np.testing.assert_array_equal(it[row].numpy(), np.asarray(jax.lax.top_k(x, 300)[1]))


_jax_detect_jit = jax.jit(jxf.detect_and_compute, static_argnames=("top_k", "refine_subpix"))


def _jax_detect(jax_params, img, top_k, refine_subpix=False):
    """One compile per image shape and setting."""
    return jax.device_get(_jax_detect_jit(jax_params, jnp.asarray(img), top_k=top_k,
                                          refine_subpix=refine_subpix))


def _compare_detections(got, ref, kp_atol=0.0):
    kp, desc, score, valid = (x.numpy() for x in got)
    kp_j, desc_j, score_j, valid_j = ref
    np.testing.assert_array_equal(valid, valid_j)
    # every slot, the invalid ones too
    np.testing.assert_allclose(kp, kp_j, rtol=0, atol=kp_atol)
    np.testing.assert_allclose(score, score_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(desc, desc_j, rtol=0, atol=1e-4)
    return int(valid_j.sum())


@pytest.mark.parametrize("h, w, top_k", [
    (96, 128, 300),  # /32 sides, more slots than peaks: invalid slots
    (100, 90, 64),  # the resize path (96 x 64 inside)
])
def test_detect_and_compute_matches_jax(jax_params, model, h, w, top_k):
    """Four textures (the random_texture families), keypoints equal in
    every slot."""
    n_valid = 0
    for seed in range(4):
        img = _texture(seed, h, w)
        ref = _jax_detect(jax_params, img, top_k)
        got = txf.detect_and_compute(model, torch.as_tensor(img), top_k=top_k)
        n_valid += _compare_detections(got, ref)
    assert n_valid > 40


def test_refine_subpix_matches_jax(jax_params, model):
    """The refined coordinates are a ratio of heatmap differences, so the
    float32 rounding of the two packages' convolutions moves them (7.6e-6 px
    seen at 96 x 96): they are held to 1e-4 px, the integer peaks under them
    exactly, and the refinement moves nothing else."""
    img = _texture(1, 96, 96)
    ref = _jax_detect(jax_params, img, 48, refine_subpix=True)
    got = txf.detect_and_compute(model, torch.as_tensor(img), top_k=48, refine_subpix=True)
    assert _compare_detections(got, ref, kp_atol=1e-4) > 10
    plain = txf.detect_and_compute(model, torch.as_tensor(img), top_k=48)
    np.testing.assert_array_equal(plain[0].numpy(), _jax_detect(jax_params, img, 48)[0])
    off = (got[0] - plain[0]).abs()
    assert off.max() <= 0.5 and off.max() > 0
    for a, b in zip(got[1:], plain[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_stack_equals_single_calls(model):
    imgs = np.stack([_texture(s, 96, 128) for s in range(3)])
    stacked = txf.batched_detect_and_compute(model, torch.as_tensor(imgs), top_k=64)
    for i, img in enumerate(imgs):
        single = txf.detect_and_compute(model, torch.as_tensor(img), top_k=64)
        for a, b in zip(stacked, single):
            assert a[i].shape == b.shape
            torch.testing.assert_close(a[i], b, rtol=0, atol=1e-6)
        torch.testing.assert_close(stacked[0][i], single[0], rtol=0, atol=0)
        torch.testing.assert_close(stacked[3][i], single[3], rtol=0, atol=0)
    with pytest.raises(ValueError, match="stack"):
        txf.batched_detect_and_compute(model, torch.as_tensor(imgs[0]))


def test_convert_torch_state_dict_matches_the_jax_converter():
    from tests.oracle.torch_xfeat import XFeat

    upstream = XFeat(seed=7).upstream_state_dict()
    tree = jxf.convert_torch_state_dict({k: v.numpy() for k, v in upstream.items()})
    ref = txf.state_dict_from_flax(jax.tree.map(np.asarray, tree))
    got = txf.convert_torch_state_dict(upstream)
    assert set(got) == set(ref) == set(txf.XFeatModel().state_dict())
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)


@pytest.mark.parametrize("prefix", ["net.", ""])
def test_load_xfeat_checkpoint(tmp_path, prefix):
    """An ``xfeat.pt`` with or without the ``net.`` prefix, through
    ``torch.load(weights_only=True)``, against the JAX package's loader."""
    from tests.oracle.torch_xfeat import XFeat

    upstream = XFeat(seed=3).upstream_state_dict()
    path = tmp_path / "xfeat.pt"
    torch.save({prefix + k[len("net."):]: v for k, v in upstream.items()}, path)
    got = txf.load_xfeat_checkpoint(str(path))
    ref = txf.state_dict_from_flax(jax.tree.map(
        np.asarray, jxf.load_xfeat_checkpoint(str(path))))
    assert set(got) == set(ref)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)
    txf.XFeatModel().load_state_dict(got)


def test_match_semantics():
    rng = np.random.default_rng(5)
    d1 = rng.normal(size=(20, 16))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    perm = rng.permutation(20)
    d2 = d1[perm]
    fx = FeatureExtractor.__new__(FeatureExtractor)  # no model needed
    i1, i2 = fx.match(d1, d2, min_cossim=0.9)
    assert len(i1) == 20
    np.testing.assert_array_equal(perm[i2], i1)
    # against the JAX package's on descriptors with non-matches and a threshold
    d3 = np.concatenate([d1[:12], rng.normal(size=(8, 16))])
    d3 /= np.linalg.norm(d3, axis=1, keepdims=True)
    jfx = JaxExtractor.__new__(JaxExtractor)
    for cos in (0.0, 0.82):
        for a, b in zip(fx.match(d1, d3, cos), JaxExtractor.match(jfx, d1, d3, cos)):
            np.testing.assert_array_equal(a, b)
    kp = rng.uniform(size=(20, 2))
    sc = rng.uniform(size=20)
    (k1, _, s1), (k2, _, s2) = match_frames(fx, kp, d1, sc, kp[perm], d2, sc[perm])
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(s1, s2)


def test_extract_features_drops_invalid_slots(model):
    fx = FeatureExtractor(model, top_k=300, device="cpu")
    img = _texture(11, 96, 128)
    kp, desc, score = fx.extract_features(img)
    kp_t, desc_t, score_t, valid = txf.detect_and_compute(model, torch.as_tensor(img))
    n = int(valid.sum())
    assert 10 < n < 300 and kp.shape == (n, 2) and desc.shape == (n, 64)
    np.testing.assert_array_equal(kp, kp_t[:n].numpy())
    np.testing.assert_array_equal(score, score_t[:n].numpy())
    assert (score > 0).all()


def test_init_params_draws_flax_lecun_normal():
    """Kernels from a unit normal truncated to [-2, 2], scaled to variance
    1 / fan_in (Flax's lecun_normal), zero biases, statistics 0 and 1."""
    model = txf.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert not model.training
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            assert torch.equal(p, torch.zeros_like(p)), name
            continue
        fan_in = p.shape[1] * p.shape[2] * p.shape[3]
        assert (p.abs() * np.sqrt(fan_in)).max() <= 2.0 / 0.87962566 + 1e-6, name
    big = model.block5_1.conv.weight.detach()  # 147,456 draws, fan_in 1,152
    assert abs(float(big.var()) * 1152 - 1.0) <= 0.05
    for name, b in model.named_buffers():
        assert torch.equal(b, torch.zeros_like(b) if name.endswith("mean") else torch.ones_like(b))
    again = txf.init_params(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again.kp_conv.weight, model.kp_conv.weight)


def test_detect_and_compute_refuses_training_mode(model):
    """The batch-statistics branch belongs to the trainer: detect_and_compute
    never runs it (it would also move the running statistics)."""
    before = model.block1_0.bn_mean.clone()
    model.train()
    try:
        with pytest.raises(ValueError, match="eval mode"):
            txf.detect_and_compute(model, torch.as_tensor(_texture(0, 64, 64)))
    finally:
        model.eval()
    assert torch.equal(model.block1_0.bn_mean, before)
