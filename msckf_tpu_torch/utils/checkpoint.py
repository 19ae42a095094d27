"""Filter-state checkpoint and resume (port of
``msckf_tpu/utils/checkpoint.py``, its ``.npz`` pair).

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

from msckf_tpu_torch.config import MSCKFConfig
from msckf_tpu_torch.filter.state import FilterState, _flatten, init_state, state_from_numpy


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
