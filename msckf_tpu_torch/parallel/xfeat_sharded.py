"""Sharded XFeat inference: data-parallel images x tensor-parallel channels
(port of ``msckf_tpu/parallel/xfeat_sharded.py``).

Batched ``detect_and_compute`` over a 2-D ``("data", "model")``
``DeviceMesh`` of ranks (``torch.distributed``, one process a rank):

* images split over ``"data"`` (independent frames), and every rank gets
  the whole batch's outputs back by an all-gather over that dimension, as
  the JAX package's global array holds them;
* the wide convolutions (output channels >= 64 and divisible by the
  ``"model"`` size) keep only the rank's slice of output channels, with
  the same slice of their bias and of the batch statistics that follow;
  the slice is all-gathered over ``"model"`` into the full channel axis at
  the layer's output, the channel-mixing boundary, since the next
  convolution reads every channel (column parallelism, written out).
  DTensor's convolution rule propagates only the input's placement and
  cannot express a weight sharded on its output channels, so it is not
  used.

The gathers take CUDA tensors on NCCL and on gloo alike (gloo carries them
for ranks that share one card, which NCCL refuses). Without a process
group every mesh is one rank and no collective runs. The convolutions are
cuDNN's, as XLA's are in the JAX package; no kernel of the port runs here.

``python -m msckf_tpu_torch.parallel.xfeat_sharded`` runs one rank of a
multi-process launch on a stack of images (``--help``).
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np
import torch
from torch import nn

from msckf_tpu_torch.models import xfeat
from msckf_tpu_torch.models.xfeat import BasicLayer, XFeatModel
from msckf_tpu_torch.parallel import multihost as mh


def xfeat_mesh(n_data: int, n_model: int, device=None):
    """A ``("data", "model")`` ``DeviceMesh`` of (n_data, n_model) over
    every rank (n_data * n_model of them; one rank without a process group)
    on ``device``'s type (the GPU unless ``device="cpu"``)."""
    return mh.mesh_for(device, (n_data, n_model), ("data", "model"))


class _GatherChannels(nn.Module):
    """The rank's slice of a layer's output channels, all-gathered over the
    ``"model"`` group into the full channel axis."""

    def __init__(self, inner: nn.Module, group):
        super().__init__()
        self.inner = inner
        self.group = group

    def forward(self, x):
        return mh.all_gather_rows(self.inner(x), self.group, dim=1)


def _sliced(layer: nn.Module, lo: int, hi: int) -> nn.Module:
    """A copy of ``layer`` (a BasicLayer or a Conv2d) keeping output
    channels lo:hi of its weight, its bias and its batch statistics."""
    conv = layer.conv if isinstance(layer, BasicLayer) else layer
    if isinstance(layer, BasicLayer):
        out = BasicLayer(conv.in_channels, hi - lo, kernel=conv.kernel_size[0],
                         stride=conv.stride[0], padding=conv.padding[0],
                         dilation=conv.dilation[0])
        out.bn_mean.copy_(layer.bn_mean[lo:hi])
        out.bn_var.copy_(layer.bn_var[lo:hi])
        new = out.conv
    else:
        out = new = nn.Conv2d(conv.in_channels, hi - lo, conv.kernel_size, stride=conv.stride,
                              padding=conv.padding, dilation=conv.dilation,
                              bias=conv.bias is not None)
    with torch.no_grad():
        new.weight.copy_(conv.weight[lo:hi])
        if conv.bias is not None:
            new.bias.copy_(conv.bias[lo:hi])
    return out.to(conv.weight.device).train(layer.training)


def shard_params(model: XFeatModel, mesh) -> XFeatModel:
    """A copy of ``model`` for this rank of ``mesh``: each convolution whose
    output channels are >= 64 and divisible by the ``"model"`` size keeps
    its rank's slice of them (the JAX rule of
    ``msckf_tpu/parallel/xfeat_sharded.py:34-45``, read on torch's (O, I,
    kh, kw) layout), gathered after the layer; everything else is
    replicated."""
    n_model = mesh.shape[mesh.mesh_dim_names.index("model")]
    m = mh.mesh_coordinate(mesh, "model")
    group = mh.mesh_group(mesh, "model")
    out = copy.deepcopy(model)
    for name, layer in model.named_children():
        conv = layer.conv if isinstance(layer, BasicLayer) else layer
        O = conv.out_channels
        if O >= 64 and O % n_model == 0:
            per = O // n_model
            out.add_module(name, _GatherChannels(_sliced(layer, m * per, (m + 1) * per), group))
    return out


def batched_detect_and_compute(model: XFeatModel, images: torch.Tensor, top_k: int = 300,
                               mesh=None, refine_subpix: bool = False):
    """``detect_and_compute`` over a stack (N, H, W). Without ``mesh`` it
    is ``models/xfeat.py::batched_detect_and_compute``. With one, this
    rank's data coordinate takes its N / n_data images (N must divide),
    ``model`` may be ``shard_params``'s, and every rank returns the whole
    stack's outputs in image order."""
    if mesh is None:
        return xfeat.batched_detect_and_compute(model, images, top_k=top_k,
                                                refine_subpix=refine_subpix)
    n_data = mesh.shape[mesh.mesh_dim_names.index("data")]
    N = images.shape[0]
    if N % n_data:
        raise ValueError(f"{N} images do not divide over {n_data} data ranks")
    per = N // n_data
    d = mh.mesh_coordinate(mesh, "data")
    outs = xfeat.batched_detect_and_compute(model, images[d * per:(d + 1) * per], top_k=top_k,
                                            refine_subpix=refine_subpix)
    group = mh.mesh_group(mesh, "data")
    return tuple(mh.all_gather_rows(o, group) for o in outs)


def main(argv=None):
    """One rank: the stack in ``--images`` (.npy, (N, H, W)) through each
    mesh of ``--meshes`` (``DATAxMODEL``, comma-separated) with the weights
    of ``--weights``; rank 0 writes each mesh's outputs to
    ``{out}/mesh_{d}x{m}.npz`` (kpts, desc, scores, valid)."""
    ap = argparse.ArgumentParser(description="one rank of sharded XFeat inference")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--images", required=True)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--meshes", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--top_k", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="'cpu' for the CPU")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default: nccl on cuda, gloo on cpu)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)
    mh.init_distributed(args.coordinator, args.num_processes, args.process_id,
                        backend=args.backend, device=args.device)
    try:
        meshes = [tuple(int(v) for v in m.split("x")) for m in args.meshes.split(",")]
        model = xfeat.load_xfeat_npz(args.weights, device=args.device)
        images = torch.as_tensor(np.load(args.images), device=next(model.parameters()).device)
        os.makedirs(args.out, exist_ok=True)
        for nd, nm in meshes:
            mesh = xfeat_mesh(nd, nm, device=args.device)
            out = batched_detect_and_compute(shard_params(model, mesh), images,
                                             top_k=args.top_k, mesh=mesh)
            if torch.distributed.get_rank() == 0:
                np.savez(f"{args.out}/mesh_{nd}x{nm}.npz",
                         **{k: v.cpu().numpy()
                            for k, v in zip(("kpts", "desc", "scores", "valid"), out)})
            print(f"XFEAT rank {torch.distributed.get_rank()} mesh {nd}x{nm} "
                  f"valid={int(out[3].sum())}", flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
