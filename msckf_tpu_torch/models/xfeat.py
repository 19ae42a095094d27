"""XFeat ("accelerated features") in PyTorch: the port of
``msckf_tpu/models/xfeat.py``.

The CNN (upstream github.com/verlab/accelerated_features, NCHW as upstream):

  backbone: InstanceNorm -> block1 (1->4->8->8->24, /4) + skip -> block2
  (24->24) -> block3 (24->64, /8) -> block4 (64->64, /16) -> block5
  (64->128->64, /32); block4/5 upsampled bilinearly to 1/8 and fused ->
  64-d dense descriptors at 1/8 resolution; a 65-channel keypoint-logit head
  over 8x8-unshuffled input pixels; a sigmoid reliability heatmap head.

The modules keep the JAX package's names (``block1_0`` ... ``kp_conv``), so
each Flax weight maps onto one entry of the ``state_dict`` by name
(:func:`state_dict_from_flax`). The convolutions are cuDNN's (``F.conv2d``),
as they are XLA's in the JAX package; they run in full float32 (TF32 off,
``ops/precision.py``) on the card too.

``detect_and_compute`` is upstream's inference path with fixed shapes, the
JAX package's arithmetic op for op: bilinear resize to a /32 grid, softmax +
pixel-shuffle keypoint heatmap, 5x5 max-pool NMS as a mask, a top-k that
breaks ties toward the lowest index, ``InterpolateSparse2d``-convention
reliability and descriptor sampling (grid normalized by (W-1, H-1) yet
unnormalized with align_corners=False and zeros padding; descriptors
sampled bicubic), L2 normalization. It takes one image (H, W) or a stack
(N, H, W); a stack is one batched CNN call, post-processed on the batch
axis (one flattened gather per tap, no loop over frames).

Only inference is ported: BasicLayer's batch-statistics branch belongs to
the trainer, which is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from msckf_tpu_torch.ops.device import check_on_device, resolve_device
from msckf_tpu_torch.ops.precision import with_f32_matmuls


class BasicLayer(nn.Module):
    """Conv2d(bias=False) + BatchNorm(affine=False, running statistics) +
    ReLU, at inference."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                              dilation=dilation, bias=False)
        self.register_buffer("bn_mean", torch.zeros(out_ch))
        self.register_buffer("bn_var", torch.ones(out_ch))

    def forward(self, x):
        x = self.conv(x)
        x = (x - self.bn_mean[:, None, None]) / torch.sqrt(self.bn_var[:, None, None] + 1e-5)
        return F.relu(x)


def _bilinear_resize(x, h: int, w: int):
    """``jax.image.resize(method="bilinear", antialias=False)`` of an NCHW
    tensor: half-pixel centres, no antialiasing."""
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                         antialias=False)


# (name, in, out, kernel, stride, padding) of every BasicLayer, in order
_LAYERS = (
    ("block1_0", 1, 4, 3, 1, 1), ("block1_1", 4, 8, 3, 2, 1),
    ("block1_2", 8, 8, 3, 1, 1), ("block1_3", 8, 24, 3, 2, 1),
    ("block2_0", 24, 24, 3, 1, 1), ("block2_1", 24, 24, 3, 1, 1),
    ("block3_0", 24, 64, 3, 2, 1), ("block3_1", 64, 64, 3, 1, 1),
    ("block3_2", 64, 64, 1, 1, 0),
    ("block4_0", 64, 64, 3, 2, 1), ("block4_1", 64, 64, 3, 1, 1),
    ("block4_2", 64, 64, 3, 1, 1),
    ("block5_0", 64, 128, 3, 2, 1), ("block5_1", 128, 128, 3, 1, 1),
    ("block5_2", 128, 128, 3, 1, 1), ("block5_3", 128, 64, 1, 1, 0),
    ("fusion_0", 64, 64, 3, 1, 1), ("fusion_1", 64, 64, 3, 1, 1),
    ("heat_0", 64, 64, 1, 1, 0), ("heat_1", 64, 64, 1, 1, 0),
    ("kp_0", 64, 64, 1, 1, 0), ("kp_1", 64, 64, 1, 1, 0), ("kp_2", 64, 64, 1, 1, 0),
)
# (name, in, out) of the plain 1x1 convolutions with a bias
_CONVS = (("skip1_conv", 1, 24), ("fusion_conv", 64, 64), ("heat_conv", 64, 1),
          ("kp_conv", 64, 65))


class XFeatModel(nn.Module):
    """(B, 1, H, W) images, H and W divisible by 32 -> (feats (B, 64, H/8,
    W/8), keypoint logits (B, 65, H/8, W/8), reliability (B, 1, H/8, W/8))."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, s, p in _LAYERS:
            self.add_module(name, BasicLayer(cin, cout, kernel=k, stride=s, padding=p))
        for name, cin, cout in _CONVS:
            self.add_module(name, nn.Conv2d(cin, cout, 1))

    def forward(self, x):
        # InstanceNorm2d(1): per-image standardization, population variance
        mu = x.mean(dim=(2, 3), keepdim=True)
        var = ((x - mu) ** 2).mean(dim=(2, 3), keepdim=True)
        xn = (x - mu) / torch.sqrt(var + 1e-5)

        skip = self.skip1_conv(F.avg_pool2d(xn, 4, stride=4))
        b1 = self.block1_3(self.block1_2(self.block1_1(self.block1_0(xn))))
        b2 = self.block2_1(self.block2_0(b1 + skip))
        b3 = self.block3_2(self.block3_1(self.block3_0(b2)))
        b4 = self.block4_2(self.block4_1(self.block4_0(b3)))
        b5 = self.block5_3(self.block5_2(self.block5_1(self.block5_0(b4))))

        h8, w8 = b3.shape[2], b3.shape[3]
        fused = b3 + _bilinear_resize(b4, h8, w8) + _bilinear_resize(b5, h8, w8)
        feats = self.fusion_conv(self.fusion_1(self.fusion_0(fused)))

        heatmap = torch.sigmoid(self.heat_conv(self.heat_1(self.heat_0(feats))))

        # keypoint head over 8x8-unshuffled raw pixels (channel r * 8 + c)
        unf = F.pixel_unshuffle(xn, 8)
        kp_logits = self.kp_conv(self.kp_2(self.kp_1(self.kp_0(unf))))
        return feats, kp_logits, heatmap


def keypoint_heatmap(kp_logits: torch.Tensor, temp: float = 1.0) -> torch.Tensor:
    """Softmax over 65 cells (64 positions + dustbin), drop the dustbin,
    pixel-shuffle back to full resolution. (B, 65, H/8, W/8) -> (B, H, W)."""
    sm = torch.softmax(kp_logits * temp, dim=1)[:, :64]
    return F.pixel_shuffle(sm, 8)[:, 0]


def _sparse_coords(pos: torch.Tensor, H_full: int, W_full: int, h: int, w: int):
    """Upstream ``InterpolateSparse2d``'s coordinate transform: positions
    normalized by (W_full-1, H_full-1) (the align_corners=True convention)
    but unnormalized onto the (h, w) grid with align_corners=False, a mixed
    convention that shifts samples by about half a cell. Part of the
    upstream spec; replicated exactly."""
    gx = 2.0 * pos[..., 0] / (W_full - 1.0) - 1.0
    gy = 2.0 * pos[..., 1] / (H_full - 1.0) - 1.0
    ix = ((gx + 1.0) * w - 1.0) / 2.0
    iy = ((gy + 1.0) * h - 1.0) / 2.0
    return ix, iy


def _gather_zeros(grid: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """grid[b, iy, ix] with zeros padding (grid_sample's default).
    grid (B, h, w, C); iy, ix integer (B, N) -> (B, N, C). The batch axis
    folds into the row index, so a stack is one gather."""
    B, h, w, C = grid.shape
    ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    rows = (torch.arange(B, device=grid.device)[:, None] * (h * w)
            + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1))
    v = grid.reshape(B * h * w, C)[rows.reshape(-1)].reshape(B, -1, C)
    return torch.where(ok[..., None], v, torch.zeros((), dtype=grid.dtype, device=grid.device))


def _cubic_weights(t: torch.Tensor):
    """grid_sample's bicubic coefficients (cubic convolution, A = -0.75) of
    the 4-tap neighbourhood at fractional offset t in [0, 1)."""
    A = -0.75

    def cc1(x):  # |x| <= 1
        return ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0

    def cc2(x):  # 1 < |x| < 2
        return ((A * x - 5.0 * A) * x + 8.0 * A) * x - 4.0 * A

    return cc2(t + 1.0), cc1(t), cc1(1.0 - t), cc2(2.0 - t)


def interpolate_sparse(grid: torch.Tensor, pos: torch.Tensor, H_full: int, W_full: int,
                       mode: str = "bilinear") -> torch.Tensor:
    """Upstream ``InterpolateSparse2d``: grid_sample(mode, align_corners=
    False, zeros padding) at xy positions normalized by the full-resolution
    extent. grid (h, w, C) or (B, h, w, C), channels last as in the JAX
    package; pos (N, 2) or (B, N, 2) -> (N, C) or (B, N, C). The bicubic
    form is the explicit 16-tap sum of the JAX package, in its order."""
    single = grid.ndim == 3
    if single:
        grid, pos = grid[None], pos[None]
    h, w = grid.shape[1], grid.shape[2]
    ix, iy = _sparse_coords(pos, H_full, W_full, h, w)
    if mode == "nearest":
        # torch.round rounds half to even, as jnp.round does
        out = _gather_zeros(grid, torch.round(iy).long(), torch.round(ix).long())
        return out[0] if single else out
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    tx = (ix - x0)[..., None]
    ty = (iy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    if mode == "bilinear":
        v00 = _gather_zeros(grid, y0, x0)
        v01 = _gather_zeros(grid, y0, x0 + 1)
        v10 = _gather_zeros(grid, y0 + 1, x0)
        v11 = _gather_zeros(grid, y0 + 1, x0 + 1)
        out = (1 - ty) * ((1 - tx) * v00 + tx * v01) + ty * ((1 - tx) * v10 + tx * v11)
        return out[0] if single else out
    if mode != "bicubic":
        raise ValueError(f"mode must be nearest, bilinear or bicubic, got {mode!r}")
    wx = _cubic_weights(tx)
    wy = _cubic_weights(ty)
    out = torch.zeros(pos.shape[:-1] + (grid.shape[-1],), dtype=grid.dtype, device=grid.device)
    for dy in range(4):
        row = torch.zeros_like(out)
        for dx in range(4):
            row = row + wx[dx] * _gather_zeros(grid, y0 + dy - 1, x0 + dx - 1)
        out = out + wy[dy] * row
    return out[0] if single else out


def _reliability_fullres(rel: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear ``interpolate_sparse`` of the 1/8-resolution reliability map
    (..., h, w) at every full-resolution pixel -> (..., H, W), as one 1-D
    pass per axis (the coordinate transform is affine per axis, and bilinear
    weights with zeros padding factorize). The taps are in rel's dtype."""
    h, w = rel.shape[-2], rel.shape[-1]

    def axis_taps(n_out, n_in, full):
        i = torch.arange(n_out, dtype=rel.dtype, device=rel.device)
        i = (((2.0 * i / (full - 1.0) - 1.0) + 1.0) * n_in - 1.0) / 2.0
        i0 = torch.floor(i)
        t = i - i0
        i0 = i0.long()
        ok0 = (i0 >= 0) & (i0 < n_in)
        ok1 = (i0 + 1 >= 0) & (i0 + 1 < n_in)
        zero = torch.zeros((), dtype=rel.dtype, device=rel.device)
        return (i0.clamp(0, n_in - 1), (i0 + 1).clamp(0, n_in - 1),
                torch.where(ok0, 1.0 - t, zero), torch.where(ok1, t, zero))

    x0, x1, wx0, wx1 = axis_taps(W, w, W)
    y0, y1, wy0, wy1 = axis_taps(H, h, H)
    cols = wx0 * rel[..., x0] + wx1 * rel[..., x1]  # (..., h, W)
    return wy0[:, None] * cols[..., y0, :] + wy1[:, None] * cols[..., y1, :]


def topk_lowest_index(scores: torch.Tensor, k: int):
    """The k largest entries of the last axis and their indices, ties broken
    toward the lowest index, as ``jax.lax.top_k`` breaks them (the JAX
    package's two-stage form has the same result). ``torch.topk`` promises
    no order among ties, and ties are the rule here: every non-peak pixel
    scores -1, so a stable descending sort is used."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@with_f32_matmuls
def detect_and_compute(model: XFeatModel, image: torch.Tensor, top_k: int = 300,
                       nms_threshold: float = 0.05, nms_kernel: int = 5,
                       refine_subpix: bool = False):
    """Upstream ``XFeat.detectAndCompute`` with fixed shapes.

    ``image``: (H, W) or a stack (N, H, W), grayscale in [0, 255] or [0, 1],
    on the model's device; the CNN runs in float32. Returns keypoints
    (..., top_k, 2) xy pixels in the input frame, descriptors (..., top_k,
    64) L2 normalized, scores (..., top_k) and valid (..., top_k) bool.
    Invalid slots carry score -1, upstream's sentinel.

    ``refine_subpix`` (off by default, which is upstream-exact): refine each
    peak's output coordinate by a 1-D quadratic fit per axis over the 3x3
    heatmap neighbourhood (offset in [-1/2, 1/2] px). Descriptors and scores
    stay sampled at the integer peak.
    """
    dev = next(model.parameters()).device
    check_on_device(image, dev, "the image")
    single = image.ndim == 2
    H0, W0 = image.shape[-2], image.shape[-1]
    if H0 < 32 or W0 < 32:
        raise ValueError(f"image must be at least 32x32, got {H0}x{W0}")
    # upstream preprocess: bilinear-resize (shrink) to multiples of 32, and
    # scale the keypoints back at the end
    H = (H0 // 32) * 32
    W = (W0 // 32) * 32
    x = image.reshape(-1, 1, H0, W0).to(torch.float32)
    B = x.shape[0]
    with torch.no_grad():
        if (H, W) != (H0, W0):
            x = _bilinear_resize(x, H, W)
        feats, kp_logits, reliability = model(x)
        feats = feats / torch.linalg.vector_norm(feats, dim=1, keepdim=True).clamp(min=1e-12)

        hm = keypoint_heatmap(kp_logits)  # (B, H, W)
        # max-pool NMS as a mask ("SAME" padding with -inf)
        local_max = F.max_pool2d(hm[:, None], nms_kernel, stride=1,
                                 padding=nms_kernel // 2)[:, 0]
        is_peak = (hm == local_max) & (hm > nms_threshold)
        # upstream pads its peak list with (0, 0) rows and forces their score
        # to -1, which also kills a genuine peak at pixel (0, 0); peaks on the
        # last row and column are dead upstream too (their nearest sample
        # rounds out of bounds, zeros padding scores them 0) -- replicated
        is_peak[:, 0, 0] = False
        is_peak[:, H - 1, :] = False
        is_peak[:, :, W - 1] = False

        # score = heatmap at the peak * sparse-bilinear reliability
        rel_up = _reliability_fullres(reliability[:, 0], H, W)
        score_map = torch.where(is_peak, hm * rel_up,
                                torch.full((), -1.0, dtype=hm.dtype, device=dev))
        top_scores, top_idx = topk_lowest_index(score_map.reshape(B, H * W), top_k)
        iy = top_idx // W
        ix = top_idx % W
        kpts = torch.stack([ix, iy], dim=-1).to(torch.float32)  # (B, top_k, 2)

        # bicubic descriptor sampling on the 1/8 map
        desc = interpolate_sparse(feats.permute(0, 2, 3, 1), kpts, H, W, mode="bicubic")
        desc = desc / torch.linalg.vector_norm(desc, dim=-1, keepdim=True).clamp(min=1e-12)
        valid = top_scores > 0

        if refine_subpix:
            # parabola vertex per axis on the 3x3 heatmap neighbourhood:
            # offset = (h[-1] - h[+1]) / (2 (h[-1] - 2 h[0] + h[+1])); flat
            # neighbourhoods get offset 0
            hm_flat = hm.reshape(B, H * W)

            def tap(dy, dx):
                return torch.gather(hm_flat, 1, (iy + dy).clamp(0, H - 1) * W
                                    + (ix + dx).clamp(0, W - 1))

            c = tap(0, 0)
            left, right = tap(0, -1), tap(0, 1)
            up, down = tap(-1, 0), tap(1, 0)

            def vertex(lo, hi):
                den = lo - 2.0 * c + hi
                flat = torch.abs(den) < 1e-12
                off = 0.5 * (lo - hi) / torch.where(flat, torch.ones_like(den), den)
                return torch.where(flat, torch.zeros_like(off), off).clamp(-0.5, 0.5)

            kpts = kpts + torch.stack([vertex(left, right), vertex(up, down)], dim=-1)

        # scale keypoints back to the input frame (upstream rw1/rh1)
        kpts = kpts * torch.tensor([W0 / W, H0 / H], dtype=kpts.dtype, device=dev)
    if single:
        return kpts[0], desc[0], top_scores[0], valid[0]
    return kpts, desc, top_scores, valid


def batched_detect_and_compute(model: XFeatModel, images: torch.Tensor, top_k: int = 300,
                               refine_subpix: bool = False):
    """``detect_and_compute`` over a stack (N, H, W): one batched CNN call
    (the single-device form of the JAX package's
    ``parallel/xfeat_sharded.py::batched_detect_and_compute``)."""
    if images.ndim != 3:
        raise ValueError(f"images must be a stack (N, H, W), got shape {tuple(images.shape)}")
    return detect_and_compute(model, images, top_k=top_k, refine_subpix=refine_subpix)


def init_params(generator: torch.Generator, device=None) -> XFeatModel:
    """A model with random weights drawn from ``generator`` (Flax's default
    initializers: LeCun-normal kernels, zero biases, batch statistics mean 0
    and variance 1), on ``device`` (the GPU unless ``device="cpu"``)."""
    model = XFeatModel()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=generator) / np.sqrt(fan_in))
            else:
                p.zero_()
    return model.to(resolve_device(device)).eval()


# ---------------------------------------------------------------- weights


def load_npz_params(path: str) -> dict:
    """A Flax variable tree of numpy arrays from an ``.npz`` written by the
    JAX package's trainer (keys ``params/<module>/.../kernel`` and
    ``batch_stats/<module>/bn_mean``), e.g. ``weights/xfeat_selfsup.npz``."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return tree


def state_dict_from_flax(variables: dict) -> dict:
    """The module's ``state_dict`` from a Flax variable tree of the JAX
    package's ``XFeatModel`` (numpy or array-like leaves). Kernels go from
    HWIO to OIHW."""

    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32))

    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for name, *_ in _LAYERS:
        sd[f"{name}.conv.weight"] = t(params[name]["conv"]["kernel"]).permute(3, 2, 0, 1)
        sd[f"{name}.bn_mean"] = t(stats[name]["bn_mean"])
        sd[f"{name}.bn_var"] = t(stats[name]["bn_var"])
    for name, *_ in _CONVS:
        sd[f"{name}.weight"] = t(params[name]["kernel"]).permute(3, 2, 0, 1)
        sd[f"{name}.bias"] = t(params[name]["bias"])
    return {k: v.contiguous() for k, v in sd.items()}


def load_xfeat_npz(path: str, device=None) -> XFeatModel:
    """The model with the weights of an ``.npz`` variable tree, on
    ``device`` (the GPU unless ``device="cpu"``)."""
    model = XFeatModel()
    model.load_state_dict(state_dict_from_flax(load_npz_params(path)))
    return model.to(resolve_device(device)).eval()


# our module name -> upstream state_dict prefix (net.* in xfeat.pt)
_TORCH_PREFIXES = {
    "block1_0": "block1.0", "block1_1": "block1.1",
    "block1_2": "block1.2", "block1_3": "block1.3",
    "block2_0": "block2.0", "block2_1": "block2.1",
    "block3_0": "block3.0", "block3_1": "block3.1", "block3_2": "block3.2",
    "block4_0": "block4.0", "block4_1": "block4.1", "block4_2": "block4.2",
    "block5_0": "block5.0", "block5_1": "block5.1",
    "block5_2": "block5.2", "block5_3": "block5.3",
    "fusion_0": "block_fusion.0", "fusion_1": "block_fusion.1",
    "heat_0": "heatmap_head.0", "heat_1": "heatmap_head.1",
    "kp_0": "keypoint_head.0", "kp_1": "keypoint_head.1", "kp_2": "keypoint_head.2",
}

_TORCH_CONVS = {
    "skip1_conv": "skip1.1",
    "fusion_conv": "block_fusion.2",
    "heat_conv": "heatmap_head.2",
    "kp_conv": "keypoint_head.3",
}


def convert_torch_state_dict(state_dict: dict, strip: str = "net.") -> dict:
    """Map an upstream XFeat ``state_dict`` (torch tensors or numpy arrays)
    onto this module's ``state_dict``. Both are OIHW, so only the names
    change; BasicLayer batch-norm running statistics map to ``bn_mean`` and
    ``bn_var``."""

    def get(key):
        v = state_dict[strip + key] if (strip + key) in state_dict else state_dict[key]
        return torch.tensor(np.asarray(v.numpy() if hasattr(v, "numpy") else v,
                                       dtype=np.float32))

    sd = {}
    for ours, theirs in _TORCH_PREFIXES.items():
        sd[f"{ours}.conv.weight"] = get(f"{theirs}.layer.0.weight")
        sd[f"{ours}.bn_mean"] = get(f"{theirs}.layer.1.running_mean")
        sd[f"{ours}.bn_var"] = get(f"{theirs}.layer.1.running_var")
    for ours, theirs in _TORCH_CONVS.items():
        sd[f"{ours}.weight"] = get(f"{theirs}.weight")
        if f"{strip}{theirs}.bias" in state_dict or f"{theirs}.bias" in state_dict:
            sd[f"{ours}.bias"] = get(f"{theirs}.bias")
    return sd


def load_xfeat_checkpoint(path: str) -> dict:
    """An upstream ``xfeat.pt`` checkpoint (a torch state_dict, loaded with
    ``weights_only=True``) as this module's ``state_dict``. The checkpoint
    is not bundled; download it from github.com/verlab/accelerated_features
    and pass the local path."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_torch_state_dict(
        sd, strip="net." if any(k.startswith("net.") for k in sd) else "")
