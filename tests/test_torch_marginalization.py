"""The port's window management (``filter/marginalization.py``,
``filter/tracks.py::compact_observations``) against the JAX package, on the
CPU in float64, bitwise.

The port answers every per-camera question from one lookup of each
observation's camera slot (``observation_cam_slots``, a binary search of
the ids in slot order) by gathers and scatters; the JAX package from
(F, M, N) compares of observation ids against slot ids. The states are
built with numpy for both packages: the forced ties of
tests/test_prune_tiebreak.py, dead (-1) and stale observations, invalid
tracks, free slots, an id that matches no slot, a full window, and random
windows. Each helper also runs under ``torch.func.vmap`` over three states
(a per-row fallback warns, and the warning is an error here) against its
single calls. The window's invariant the port relies on (valid slots a
prefix with strictly ascending ids, free slots -1, each live observation's
camera in the window, valid tracks' ids unique and non-negative) is checked on every state the port's loop looks up
over a saturating run, where the lookup must equal the compare form.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msckf_tpu.config import reference_experiment_config as jax_config
from msckf_tpu.filter import marginalization as jm
from msckf_tpu.filter.tracks import compact_observations as jax_compact_observations

import msckf_tpu_torch as mt
import msckf_tpu_torch.filter.marginalization as tm
import msckf_tpu_torch.filter.msckf as tmsckf
from msckf_tpu_torch.data.stream import to_device
from msckf_tpu_torch.filter.state import OBS_CAM_ID
from msckf_tpu_torch.filter.tracks import compact_observations

from tests.test_torch_modules import jax_state_from_numpy, jax_state_to_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

CAPS = dict(dtype="float64", f_max=16, k_max=16, u_max=8, m_max=6, n_cam_slots=8,
            max_camera_states=6, desc_dim=4)
DEAD = -1.0


def _cfgs():
    return mt.reference_experiment_config(**CAPS), jax_config(**CAPS)


def _window(cfg, rng, cam_ids, tracks, n_obs=None):
    """A flat state dict: cameras ``cam_ids`` in the first slots (random
    poses), a random covariance, and ``tracks`` as (slot, track_id, valid,
    [camera id of each observation]); ``n_obs`` (slot -> count) cuts a
    track's live observations short of those written, which stay as stale
    observations behind it. Unwritten observations hold the -1 id."""
    d = mt.state_to_numpy(mt.init_state(cfg, device="cpu"))
    n = len(cam_ids)
    d["cams.cam_id"][:n] = cam_ids
    d["cams.valid"][:n] = True
    d["cams.n"] = np.asarray(n)
    d["cams.R"][:n] = rng.normal(size=(n, 3, 3))
    d["cams.t"][:n] = rng.normal(size=(n, 3))
    d["P"] = rng.normal(size=d["P"].shape)
    obs = d["tracks.obs"]
    obs[...] = rng.normal(size=obs.shape)
    obs[..., OBS_CAM_ID] = DEAD
    for slot, tid, valid, ids in tracks:
        obs[slot, :len(ids), OBS_CAM_ID] = ids
        d["tracks.n_obs"][slot] = len(ids) if n_obs is None else n_obs.get(slot, len(ids))
        d["tracks.valid"][slot] = valid
        d["tracks.track_id"][slot] = tid
    return d


def _random_window(cfg, rng, n_cams):
    """``n_cams`` cameras with ascending random ids, 12 random tracks of
    random length over them (recycled slots, shuffled creation order), a
    few observations of an id in no slot, stale observations behind
    ``n_obs``, and two invalid tracks."""
    F, M = cfg.f_max, cfg.m_max
    ids = np.sort(rng.choice(np.arange(3, 400), n_cams, replace=False))
    slots = rng.choice(F, 12, replace=False)
    tids = rng.permutation(40)[:12]
    specs, n_obs = [], {}
    for k, (slot, tid) in enumerate(zip(slots, tids)):
        m = int(rng.integers(1, M + 1))
        cams = rng.choice(ids, m)
        cams[rng.uniform(size=m) < 0.1] = 999  # in no slot
        specs.append((int(slot), int(tid), k >= 2, cams))
        n_obs[int(slot)] = int(rng.integers(1, m + 1))
    return _window(cfg, rng, ids, specs, n_obs)


def _fixed_windows(cfg, rng):
    N, M = cfg.n_cam_slots, cfg.m_max
    full = list(range(7, 7 + 3 * N, 3))
    return {
        # tests/test_prune_tiebreak.py: every count ties; recycled slots
        "forced_tie": _window(cfg, rng, [10, 20, 30], [(0, 2, True, [10]), (1, 0, True, [20]),
                                                       (2, 1, True, [30])]),
        "within_track": _window(cfg, rng, [5, 7, 9], [(0, 0, True, [7, 9]), (1, 1, True, [5])]),
        # stale observations past n_obs, an invalid track over live cameras,
        # an id in no slot, and a camera seen by no live observation
        "dead_and_stale": _window(
            cfg, rng, [4, 6, 8, 12],
            [(3, 5, True, [4, 6, 12, 8]), (5, 2, False, [4, 8, 12]), (6, 9, True, [6, 77]),
             (9, 1, True, [8, 12])],
            n_obs={3: 2, 9: 1},
        ),
        "empty_window": _window(cfg, rng, [], []),
        "full": _window(cfg, rng, full, [(f, 20 - f, True, [full[(f + j) % N] for j in range(M)])
                                         for f in range(0, 14, 2)]),
    }


def _windows(cfg):
    rng = np.random.default_rng(22)
    out = _fixed_windows(cfg, rng)
    for k, n_cams in enumerate((3, 5, cfg.n_cam_slots)):
        out[f"random{k}"] = _random_window(cfg, rng, n_cams)
    return out


WINDOWS = list(_windows(_cfgs()[0]))


def _bits(x):
    """An array as its bits where it is floating point."""
    x = np.asarray(x)
    return x.view(np.uint64) if x.dtype == np.float64 else x


def _same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if want.dtype == np.float64:
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)


def _same_state(got, want):
    got, want = mt.state_to_numpy(got), jax_state_to_numpy(want)
    assert got.keys() == want.keys()
    for k in got:
        _same(got[k], want[k], k)


def _victim_masks(cfg, d):
    """More victim masks: none, every other valid slot, and every other slot
    (free ones too, which must change nothing)."""
    valid = d["cams.valid"]
    alt = (np.arange(cfg.n_cam_slots) % 2 == 0)
    return [np.zeros_like(valid), alt & valid, alt]


@pytest.mark.parametrize("name", WINDOWS)
def test_window_helpers_match_jax_bitwise(name):
    cfg, jcfg = _cfgs()
    d = _windows(cfg)[name]
    st = mt.state_from_numpy(d, device="cpu")
    jst = jax_state_from_numpy(jcfg, d)

    victim = tm.select_prune_victims(cfg, st)
    _same(victim, jm.select_prune_victims(jcfg, jst), "select_prune_victims")
    _same(tm.camera_first_encounter_rank(cfg, st), jm.camera_first_encounter_rank(jcfg, jst),
          "camera_first_encounter_rank")
    _same(tm.camera_observation_counts(cfg, st), jm.camera_observation_counts(jcfg, jst),
          "camera_observation_counts")
    empty = tm.cameras_without_features(cfg, st)
    _same(empty, jm.cameras_without_features(jcfg, jst), "cameras_without_features")

    for v in [victim.numpy(), empty.numpy()] + _victim_masks(cfg, d):
        _same_state(tm.remove_cameras(cfg, st, torch.as_tensor(v)),
                    jm.remove_cameras(jcfg, jst, jnp.asarray(v)))

    keep = np.random.default_rng(len(name)).uniform(size=d["tracks.n_obs"].shape + (cfg.m_max,))
    for k in (keep < 0.7, np.ones_like(keep, bool), np.zeros_like(keep, bool)):
        _same_state(st.replace(tracks=compact_observations(st.tracks, torch.as_tensor(k))),
                    jst.replace(tracks=jax_compact_observations(jst.tracks, jnp.asarray(k))))
    if name in ("forced_tie", "within_track", "dead_and_stale", "full"):
        assert victim.any()


def test_window_helpers_under_vmap():
    """Each helper under ``torch.func.vmap`` over three windows, with the
    vmap fallback's warning an error, bitwise its single calls."""
    cfg, _ = _cfgs()
    ws = _windows(cfg)
    ds = [ws["dead_and_stale"], ws["random0"], ws["full"]]
    singles = [mt.state_from_numpy(d, device="cpu") for d in ds]
    stacked = mt.state_from_numpy({k: np.stack([d[k] for d in ds]) for k in ds[0]},
                                  device="cpu")
    rng = np.random.default_rng(3)
    victims = torch.as_tensor(rng.uniform(size=(3, cfg.n_cam_slots)) < 0.4)
    keeps = torch.as_tensor(rng.uniform(size=(3, cfg.f_max, cfg.m_max)) < 0.7)
    cases = {
        "observation_cam_slots": (lambda s, v, k: tm.observation_cam_slots(s)),
        "select_prune_victims": (lambda s, v, k: tm.select_prune_victims(cfg, s)),
        "camera_first_encounter_rank": (lambda s, v, k: tm.camera_first_encounter_rank(cfg, s)),
        "camera_observation_counts": (lambda s, v, k: tm.camera_observation_counts(cfg, s)),
        "cameras_without_features": (lambda s, v, k: tm.cameras_without_features(cfg, s)),
        "remove_cameras": (lambda s, v, k: tm.remove_cameras(cfg, s, v)),
        "compact_observations": (lambda s, v, k: compact_observations(s.tracks, k)),
    }
    for name, fn in cases.items():
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a per-row fallback warns
            got = torch.func.vmap(fn)(stacked, victims, keeps)
        flat, _ = torch.utils._pytree.tree_flatten(got)
        for b in range(3):
            want, _ = torch.utils._pytree.tree_flatten(fn(singles[b], victims[b], keeps[b]))
            assert len(flat) == len(want)
            for x, y in zip(flat, want):
                _same(x[b].numpy(), y.numpy(), f"{name}[{b}]")


def test_window_invariant_holds_over_a_run(monkeypatch):
    """Over a saturating run of the port's loop (a window of three cameras,
    so the prune runs on most frames, in both prune paths), every state
    the lookup sees keeps the invariant, and the lookup equals the compare
    of observation ids against valid slot ids."""
    caps = dict(dtype="float64", f_max=96, u_max=16, k_max=96, m_max=6, n_cam_slots=6,
                max_camera_states=3, min_parallax_deg=20.0, desc_dim=10)
    seen = []
    lookup = tm.observation_cam_slots

    def checked(state):
        cams, tr = state.cams, state.tracks
        valid, ids = cams.valid.numpy(), cams.cam_id.numpy()
        n = int(valid.sum())
        assert valid[:n].all() and not valid[n:].any()
        assert (np.diff(ids[:n]) > 0).all() and (ids[:n] >= 0).all() and (ids[n:] == -1).all()
        tid = tr.track_id[tr.valid].numpy()
        assert len(np.unique(tid)) == len(tid) and (tid >= 0).all()
        live = (tr.valid[:, None] & tr.obs_valid).numpy()
        assert np.isin(tr.obs_cam_id.numpy()[live], ids[:n]).all()
        slot, found = lookup(state)
        eq = (tr.obs_cam_id[..., None] == cams.cam_id) & cams.valid
        assert torch.equal(found, eq.any(-1))
        assert torch.equal(slot[found], torch.argmax(eq.to(torch.uint8), -1)[found])
        seen.append(int(live.sum()))
        return slot, found

    monkeypatch.setattr(tm, "observation_cam_slots", checked)
    monkeypatch.setattr(tmsckf, "observation_cam_slots", checked)
    for path in ("cond", "masked"):
        cfg = mt.reference_experiment_config(**caps, prune_path=path)
        std = to_device(mt.circle_streams(cfg, (1,), max_ticks=200, n_world_points=100),
                        cfg, device="cpu")
        stats = mt.FrameStats()
        state = mt.make_initial_state(cfg, std.R_init[0], device="cpu")
        mt.run_sequence(cfg, state, {k: v[0] for k, v in std.prefix.items()},
                        {k: v[0] for k, v in std.frames.items()}, device="cpu", stats=stats)
        assert int(stats.prunes) > 0
    assert len(seen) > 20 and max(seen) > 0
