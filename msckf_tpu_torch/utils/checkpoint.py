"""Filter-state checkpoint and resume (port of
``msckf_tpu/utils/checkpoint.py``).

Two pairs, as in the JAX package: the ``.npz`` pair (``save_state`` /
``load_state``) and a directory pair (``save_state_dcp`` /
``load_state_dcp``) on ``torch.distributed.checkpoint``, the counterpart of
the JAX package's Orbax pair.

The file format is the JAX package's: one ``.npz`` with keys ``leaf_0`` to
``leaf_29``, the state's arrays in the JAX pytree order. The port's
``filter/state.py::_flatten`` visits the same fields in the same order
(ImuState, CameraStates, P, TrackStore, initialized, next_track_id,
Diagnostics), so a state saved mid-sequence by either package resumes in
the other. Integers are written as the port keeps them (int64); the JAX
package writes int32, and ``load_state`` casts each leaf to the dtype of
the port's own fresh state.
"""

from __future__ import annotations

import numpy as np
import torch.distributed.checkpoint as dcp

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.state import FilterState, _flatten, init_state, state_from_numpy
from msckf_tpu_torch.ops.device import resolve_device


def save_state(path: str, state: FilterState) -> None:
    leaves = _flatten(state, "", {}).values()
    np.savez_compressed(path, **{f"leaf_{i}": v.detach().cpu().numpy()
                                 for i, v in enumerate(leaves)})


def load_state(path: str, cfg: MSCKFConfig, device=None) -> FilterState:
    """The state saved at ``path``, on ``device`` (the GPU unless
    ``device="cpu"``), with the shapes and dtypes that ``cfg`` implies (the
    configuration the checkpoint was written under). Raises ``ValueError``
    where a leaf's shape differs."""
    template = _flatten(init_state(cfg, device="cpu"), "", {})
    with np.load(path) as data:
        loaded = [data[f"leaf_{i}"] for i in range(len(template))]
    d = {}
    for i, ((key, t), leaf) in enumerate(zip(template.items(), loaded)):
        if tuple(t.shape) != leaf.shape:
            raise ValueError(
                f"checkpoint leaf {i} ({key}) shape {leaf.shape} != config shape "
                f"{tuple(t.shape)}"
            )
        d[key] = leaf.astype(t.numpy().dtype)
    return state_from_numpy(d, device)


def save_state_dcp(path: str, state: FilterState) -> None:
    """Write ``state`` as a ``torch.distributed.checkpoint`` directory at
    ``path``, one entry a leaf keyed by its field path (``"imu.R_WI"``,
    ``"P"``, ...): the counterpart of the JAX package's
    ``save_state_orbax`` (Orbax's ``StandardCheckpointer``, which also
    writes a directory). The state is this process's own: every rank of a
    multi-process run writes its own directory (``no_dist``). The port does
    not read Orbax directories; a state crosses between the packages by the
    ``.npz`` pair."""
    dcp.save(_flatten(state, "", {}), checkpoint_id=path, no_dist=True)


def load_state_dcp(path: str, cfg: MSCKFConfig, device=None) -> FilterState:
    """The state written by ``save_state_dcp`` at ``path``, restored in
    place into a fresh state of ``cfg`` (the counterpart of
    ``load_state_orbax``'s ``restore(path, init_state(cfg))``) on
    ``device`` (the GPU unless ``device="cpu"``). Raises ``ValueError``
    where a leaf's shape differs from the configuration's."""
    template = init_state(cfg, device=resolve_device(device))
    leaves = _flatten(template, "", {})
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    for i, (key, t) in enumerate(leaves.items()):
        shape = tuple(saved[key].size) if key in saved else None
        if shape != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {i} ({key}) shape {shape} != config shape "
                             f"{tuple(t.shape)}")
    dcp.load(leaves, checkpoint_id=path, no_dist=True)
    return template
