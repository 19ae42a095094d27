"""Self-supervised XFeat training in PyTorch: the port of
``msckf_tpu/models/train_xfeat.py``.

Produces *functional* weights for XFeat where the upstream ``xfeat.pt``
checkpoint is unavailable. The recipe mirrors the structure of the upstream
training (XFeat paper):

  * dense descriptor loss: dual-softmax InfoNCE between corresponding 1/8
    cells of a homography pair (``models/selfsup.py``);
  * keypoint-head distillation: cross-entropy against a Shi-Tomasi corner
    teacher (the ALIKE-distillation analog);
  * reliability head: regression onto the stop-gradient dual-softmax
    matchability of each cell, like upstream's reliability supervision.

The losses are the JAX package's arithmetic on tensors with a leading batch
axis (no loop over pairs); one forward over both images of every pair in
training mode gives the loss and updates the batch statistics
(``BasicLayer``). The optimizer is :class:`ClippedAdamW`, the JAX trainer's
``optax.chain(clip_by_global_norm(1.0), adamw(cosine_decay_schedule(lr,
steps, alpha=0.05)))``. The convolutions are cuDNN's and the similarity
products ``torch.matmul``, in full float32 (TF32 off, ``ops/precision.py``).

Train: ``python -m msckf_tpu_torch.models.train_xfeat --steps 2000 --out
weights/xfeat_selfsup.npz`` (on the GPU; ``--device cpu`` for the CPU). The
``.npz`` has the JAX package's key layout, so both packages load it.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from msckf_tpu_torch.models.frontend_eval import pair_match_stats
from msckf_tpu_torch.models.selfsup import (
    joint_corner_labels,
    make_batch,
    photometric_jitter,
    random_homography,
    random_texture,
    warp_image,
)
from msckf_tpu_torch.models.xfeat import (
    XFeatModel,
    init_params,
    load_npz_params,
    npz_arrays,
    state_dict_from_flax,
)
from msckf_tpu_torch.ops.device import resolve_device
from msckf_tpu_torch.ops.precision import with_f32_matmuls


# ------------------------------------------------------------- checkpointing


def save_npz_params(path: str, model: XFeatModel) -> None:
    """Write the model's weights and batch statistics as the JAX package's
    trainer does (keys ``params/<module>/conv/kernel`` in HWIO,
    ``batch_stats/<module>/bn_mean``, in the model's dtype): both packages'
    ``load_npz_params`` read the file."""
    np.savez(path, **npz_arrays(model.state_dict()))


# ------------------------------------------------------------------- losses


def _cell_centers(hc: int, wc: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Pixel xy of each 1/8 cell centre, (hc * wc, 2) in row-major cell
    order."""
    ys, xs = torch.meshgrid(torch.arange(hc, dtype=dtype, device=device),
                            torch.arange(wc, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xs * 8.0 + 3.5, ys * 8.0 + 3.5], dim=-1).reshape(-1, 2)


def _apply_h(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Points (..., N, 2) mapped through homographies H (..., 3, 3)."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    q = ph @ H.transpose(-1, -2)
    return q[..., :2] / q[..., 2:3]


def pair_losses(f1, f2, kpl1, kpl2, kp1_logits, kp2_logits, rel1, H, temp: float = 0.1):
    """Losses of B homography pairs from the 1/8-resolution outputs.

    f1, f2 (B, C, hc, wc) descriptors; kpl1, kpl2 (B, hc, wc) teacher labels
    0..64; kp1_logits, kp2_logits (B, 65, hc, wc); rel1 (B, hc, wc) img1's
    reliability; H (B, 3, 3) the img1 -> img2 pixel map. Returns the
    descriptor, keypoint and reliability losses and the valid cell count of
    each pair, each (B,). Cells are flattened in row-major (hc, wc) order,
    as the JAX package flattens its NHWC maps."""
    B, C, hc, wc = f1.shape
    n = hc * wc
    d1 = f1.permute(0, 2, 3, 1).reshape(B, n, C)
    d2 = f2.permute(0, 2, 3, 1).reshape(B, n, C)
    d1 = d1 / torch.linalg.vector_norm(d1, dim=-1, keepdim=True).clamp(min=1e-8)
    d2 = d2 / torch.linalg.vector_norm(d2, dim=-1, keepdim=True).clamp(min=1e-8)

    # ground-truth correspondence: cell centres of img1 mapped through H,
    # supervised with soft bilinear targets over the 4 neighbouring cells
    p1 = _cell_centers(hc, wc, f1.dtype, f1.device)
    p2 = _apply_h(H.to(f1.dtype), p1)  # (B, n, 2) pixel coords in img2
    c2x = (p2[..., 0] - 3.5) / 8.0
    c2y = (p2[..., 1] - 3.5) / 8.0
    x0f = torch.floor(c2x)
    y0f = torch.floor(c2y)
    fx = c2x - x0f
    fy = c2y - y0f
    x0 = x0f.long()
    y0 = y0f.long()

    sim = (d1 @ d2.transpose(1, 2)) / temp  # (B, n, n)
    logp12 = F.log_softmax(sim, dim=2)
    logp21 = F.log_softmax(sim, dim=1)

    zero = torch.zeros((), dtype=f1.dtype, device=f1.device)
    ll = torch.zeros((B, n), dtype=f1.dtype, device=f1.device)
    p_12 = torch.zeros_like(ll)
    p_21 = torch.zeros_like(ll)
    wsum = torch.zeros_like(ll)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        tx = x0 + dx
        ty = y0 + dy
        w = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
        ok = (tx >= 0) & (tx < wc) & (ty >= 0) & (ty < hc)
        w = torch.where(ok, w, zero)
        t = (ty * wc + tx).clamp(0, n - 1)[..., None]
        l12 = torch.gather(logp12, 2, t)[..., 0]
        l21 = torch.gather(logp21, 2, t)[..., 0]
        ll = ll + w * (l12 + l21)
        p_12 = p_12 + w * torch.exp(l12)
        p_21 = p_21 + w * torch.exp(l21)
        wsum = wsum + w
    valid = wsum > 0.5  # mostly inside img2
    n_valid = valid.sum(dim=1)
    denom = n_valid.clamp(min=1)
    wsafe = wsum.clamp(min=1e-6)
    ll = ll / wsafe
    desc_loss = -torch.where(valid, ll, zero).sum(dim=1) / denom

    # matchability target of the reliability head (no gradient)
    match_q = ((p_12 / wsafe) * (p_21 / wsafe)).detach()
    rel_loss = torch.where(valid, (rel1.reshape(B, n) - match_q) ** 2, zero).sum(dim=1) / denom

    # keypoint-head distillation (both images)
    def kp_ce(logits, labels):
        lp = F.log_softmax(logits.permute(0, 2, 3, 1).reshape(B, n, 65), dim=-1)
        return -torch.gather(lp, 2, labels.reshape(B, n, 1).long())[..., 0].mean(dim=1)

    kp_loss = 0.5 * (kp_ce(kp1_logits, kpl1) + kp_ce(kp2_logits, kpl2))
    return desc_loss, kp_loss, rel_loss, n_valid


@with_f32_matmuls
def batch_loss(model: XFeatModel, img1, img2, H, kpl1, kpl2):
    """The training loss of a batch of pairs: img1, img2 (B, S, S) in
    [0, 255], H (B, 3, 3), kpl1, kpl2 (B, S/8, S/8). One forward in training
    mode over the 2B images (batch statistics over both images of every
    pair, as in the JAX package), which also updates the model's running
    statistics in place. Returns the loss and the aux dict (desc, kp, rel,
    valid_cells)."""
    model.train()
    dtype = next(model.parameters()).dtype
    x = torch.cat([img1, img2], dim=0)[:, None].to(dtype)
    feats, kp_logits, rel = model(x)
    B = img1.shape[0]
    d, k, r, nv = pair_losses(feats[:B], feats[B:], kpl1, kpl2, kp_logits[:B], kp_logits[B:],
                              rel[:B, 0], H)
    loss = d.mean() + k.mean() + 2.0 * r.mean()
    aux = {"desc": d.mean(), "kp": k.mean(), "rel": r.mean(),
           "valid_cells": nv.to(torch.float32).mean()}
    return loss, aux


# the JAX trainer's optax chain (msckf_tpu/models/train_xfeat.py::train)
_ALPHA = 0.05  # the cosine schedule's floor, a fraction of lr
_MAX_NORM = 1.0  # clip_by_global_norm
_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def train_step(model: XFeatModel, optimizer: torch.optim.Optimizer, img1, img2, H, kpl1, kpl2):
    """One step of the JAX trainer's ``make_train_step``: the loss and its
    gradient with respect to the parameters (never the batch statistics),
    then ``optimizer.step()``. The parameters and the running statistics
    are updated in place; returns the loss and the aux dict, detached."""
    optimizer.zero_grad(set_to_none=True)
    loss, aux = batch_loss(model, img1, img2, H, kpl1, kpl2)
    loss.backward()
    optimizer.step()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


class ClippedAdamW(torch.optim.AdamW):
    """The JAX trainer's optimizer, ``optax.chain(clip_by_global_norm(1.0),
    adamw(cosine_decay_schedule(lr, steps, alpha=0.05)))`` with optax's
    defaults: b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every
    parameter (biases included).

    Each step first clips as optax does, ``g`` where the global norm is
    below 1, else ``g / norm`` (no epsilon), then takes the AdamW step with
    the learning rate ``lr * ((1 - alpha) * (1 + cos(pi * min(k, steps) /
    steps)) / 2 + alpha)``, k the count of earlier steps (the first step
    uses ``lr``). The clip reads nothing on the host."""

    def __init__(self, params, lr: float, steps: int):
        if steps <= 0:
            raise ValueError(f"the cosine schedule needs steps > 0, got {steps}")
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=_WEIGHT_DECAY)
        self.peak_lr = lr
        self.decay_steps = steps
        self.count = 0

    def schedule(self, count: int) -> float:
        k = min(count, self.decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * k / self.decay_steps))
        return self.peak_lr * ((1 - _ALPHA) * cosine + _ALPHA)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ClippedAdamW.step takes no closure")
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        if grads:
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = norm < _MAX_NORM
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * _MAX_NORM))
        for group in self.param_groups:
            group["lr"] = self.schedule(self.count)
        self.count += 1
        return super().step()


# ----------------------------------------------------------------- evaluation


def match_accuracy(model: XFeatModel, rng: np.random.Generator, n_pairs: int = 8,
                   size: int = 256, top_k: int = 200, tol_px: float = 3.0,
                   hard: bool = False):
    """Weights-quality gate: mutual-NN match precision on held-out warps.

    ``hard=False`` evaluates on mild warps (small rotation/scale: the
    frame-to-frame viewpoint change sequential VIO matching sees);
    ``hard=True`` uses the full training augmentation (rotation to 0.5 rad,
    scale 0.8-1.25). Returns (precision, mean #matches): the mean over pairs
    of ``frontend_eval.pair_match_stats``, the fraction of mutual matches
    whose reprojection error through the true homography is < tol_px. The
    model (in eval mode) runs on its own device."""
    kw = {} if hard else dict(scale=0.08, max_rot=0.1, scale_range=(0.95, 1.05))
    batch = make_batch(rng, n_pairs, size, **kw)
    stats = [pair_match_stats(model, batch.img1[b], batch.img2[b], batch.H[b],
                              top_k=top_k, tol_px=tol_px) for b in range(n_pairs)]
    return float(np.mean([p for p, _ in stats])), float(np.mean([n for _, n in stats]))


# ----------------------------------------------------------------------- CLI


class PairPool:
    """Pregenerated (texture, warp, labels) pool; draws apply fresh
    photometric jitter only (generating a pair is host work that would
    otherwise stall the device's step loop)."""

    def __init__(self, rng: np.random.Generator, n_pairs: int, size: int):
        self.rng = rng
        self.size = size
        self.img1 = np.empty((n_pairs, size, size), np.float32)
        self.img2c = np.empty((n_pairs, size, size), np.float32)  # clean warp
        self.H = np.empty((n_pairs, 3, 3), np.float32)
        hc = size // 8
        self.l1 = np.empty((n_pairs, hc, hc), np.int32)
        self.l2 = np.empty((n_pairs, hc, hc), np.int32)
        for i in range(n_pairs):
            self._generate(i)

    def _generate(self, i: int):
        base = random_texture(self.rng, self.size)
        H = random_homography(self.rng, self.size)
        warped = warp_image(base, H)
        self.img1[i] = base
        self.img2c[i] = warped
        self.H[i] = H
        # H-consistent teacher labels (selfsup.joint_corner_labels)
        self.l1[i], self.l2[i] = joint_corner_labels(base, warped, H)

    def refresh(self, n: int):
        """Regenerate ``n`` random pool entries (keeps the scene distribution
        fresh over a long run instead of overfitting the initial pool)."""
        for i in self.rng.integers(0, len(self.img1), n):
            self._generate(int(i))

    def save(self, path: str) -> None:
        """Persist the pool (images as float16: the [0, 255] range is kept to
        ~0.1 of a grey level, far below the jitter noise) so that a big pool
        can be generated offline."""
        np.savez(
            path,
            img1=self.img1.astype(np.float16),
            img2c=self.img2c.astype(np.float16),
            H=self.H, l1=self.l1, l2=self.l2,
        )

    @classmethod
    def from_file(cls, rng: np.random.Generator, path: str) -> "PairPool":
        obj = cls.__new__(cls)
        obj.rng = rng
        with np.load(path) as data:
            obj.img1 = data["img1"].astype(np.float32)
            obj.img2c = data["img2c"].astype(np.float32)
            obj.H = data["H"]
            obj.l1 = data["l1"]
            obj.l2 = data["l2"]
        obj.size = obj.img1.shape[1]
        return obj

    def draw(self, batch: int):
        idx = self.rng.integers(0, len(self.img1), batch)
        img2 = np.stack([photometric_jitter(self.rng, self.img2c[j]) for j in idx])
        return (self.img1[idx], img2, self.H[idx], self.l1[idx], self.l2[idx])


@dataclasses.dataclass
class TrainLog:
    losses: np.ndarray  # (steps,) the total loss of every step
    seconds: float  # the step loop's wall time, ending when its last step is done
    pool_seconds: float  # host time of the pool's draws and refreshes inside the loop


def train(steps=2000, batch=8, size=256, lr=1e-3, seed=0, out=None,
          log_every=50, init_variables=None, pool_pairs=400,
          refresh_every=50, refresh_n=8, eval_every=0, pool_file=None, device=None):
    """The JAX trainer's loop on ``device`` (the GPU unless ``device="cpu"``).

    Starts from ``init_variables`` (a variable tree as ``load_npz_params``
    returns it) or from ``init_params`` seeded with ``seed``.
    ``refresh_every``/``refresh_n``: regenerate refresh_n pool scenes every
    refresh_every steps (full pool turnover every pool_pairs/refresh_n *
    refresh_every steps) so long runs never overfit the initial scene draw.
    ``eval_every`` > 0: run the hard-distribution match-precision eval
    periodically and keep the BEST checkpoint (saved to ``out``) instead of
    the last. Returns the model in eval mode and a :class:`TrainLog`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if init_variables is None:
        model = init_params(torch.Generator().manual_seed(seed), device=dev)
    else:
        model = XFeatModel()
        model.load_state_dict(state_dict_from_flax(init_variables))
        model = model.to(dev)
    optimizer = ClippedAdamW(model.parameters(), lr, steps)

    t0 = time.perf_counter()
    if pool_file:
        pool = PairPool.from_file(rng, pool_file)
        print(
            f"pair pool loaded ({len(pool.img1)} pairs from {pool_file}): "
            f"{time.perf_counter() - t0:.0f}s",
            flush=True,
        )
    else:
        pool = PairPool(rng, pool_pairs, size)
        print(f"pair pool ({pool_pairs}): {time.perf_counter() - t0:.0f}s", flush=True)

    best_prec, best_state = -1.0, None
    eval_rng_seed = 999

    def hard_eval():
        model.eval()
        p_hard, n_hard = match_accuracy(model, np.random.default_rng(eval_rng_seed), hard=True)
        p_mild, _ = match_accuracy(model, np.random.default_rng(eval_rng_seed), hard=False)
        return p_hard, p_mild, n_hard

    def on_device(a):
        return torch.as_tensor(a, device=dev)

    losses = []
    pool_s = 0.0
    t0 = time.perf_counter()
    for i in range(steps):
        t_pool = time.perf_counter()
        i1, i2, Hs, l1, l2 = pool.draw(batch)
        pool_s += time.perf_counter() - t_pool
        loss, aux = train_step(model, optimizer, on_device(i1), on_device(i2), on_device(Hs),
                               on_device(l1), on_device(l2))
        losses.append(loss)
        if refresh_every and i % refresh_every == refresh_every - 1:
            t_pool = time.perf_counter()
            pool.refresh(refresh_n)
            pool_s += time.perf_counter() - t_pool
        if i % log_every == 0 or i == steps - 1:
            a = {k: float(v) for k, v in aux.items()}
            print(
                f"step {i:5d} loss {float(loss):.4f} desc {a['desc']:.4f} "
                f"kp {a['kp']:.4f} rel {a['rel']:.4f} "
                f"({time.perf_counter() - t0:.0f}s)",
                flush=True,
            )
        if eval_every and (i % eval_every == eval_every - 1 or i == steps - 1):
            ph, pm, nh = hard_eval()
            marker = ""
            if ph > best_prec:
                best_prec = ph
                best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
                marker = "  <- best"
                if out:
                    save_npz_params(out, model)
            print(
                f"eval @ step {i}: hard {ph:.3f} mild {pm:.3f} "
                f"({nh:.0f} m/p){marker}",
                flush=True,
            )
    loss_values = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
    log = TrainLog(losses=loss_values, seconds=time.perf_counter() - t0, pool_seconds=pool_s)
    model.eval()
    if eval_every and best_state is not None:
        print(f"best hard-eval {best_prec:.3f} (checkpoint kept)")
        model.load_state_dict(best_state)
    if out:
        save_npz_params(out, model)
        print(f"weights saved to {out}")
    return model, log


def main(argv=None):
    ap = argparse.ArgumentParser(description="Self-supervised XFeat training (PyTorch port)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="weights/xfeat_selfsup.npz")
    ap.add_argument("--pool", type=int, default=400)
    ap.add_argument("--resume", default="", help="npz checkpoint to continue from")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--eval_every", type=int, default=0,
                    help="periodic hard-eval cadence; keeps the best checkpoint")
    ap.add_argument("--refresh_every", type=int, default=50)
    ap.add_argument("--pool_file", default="",
                    help="pre-generated PairPool .npz (see PairPool.save); "
                    "overrides --pool")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on; 'cpu' trains on the CPU")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    init = load_npz_params(args.resume) if args.resume else None
    model, _ = train(
        steps=args.steps, batch=args.batch, size=args.size, lr=args.lr,
        seed=args.seed, out=args.out, pool_pairs=args.pool,
        init_variables=init, eval_every=args.eval_every,
        refresh_every=args.refresh_every,
        pool_file=args.pool_file or None, device=dev,
    )
    if args.eval:
        prec, nm = match_accuracy(model, np.random.default_rng(999))
        print(f"held-out match precision@3px: {prec:.3f} ({nm:.0f} matches/pair)")


if __name__ == "__main__":
    main()
