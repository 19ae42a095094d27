"""The port's public geometry, camera and one-tick propagation functions
(``ops/geometry.py``, ``ops/camera.py``, ``filter/propagation.py::
integrate_nominal`` and ``propagate``) against the JAX package's in
float64, mirroring tests/test_geometry.py and
tests/test_filter_units.py's propagation tests.

Every function takes leading batch axes where the JAX one does (a (4, 5)
batch here); ``gravity_align_rotation`` is vmapped on the JAX side, which
takes one vector, and includes the identity and -identity guards.
``R_to_quat`` meets each of Shepperd's four cases. Tolerance: 1e-12 on
every float (the two packages sum in different orders; the results agree to
a few ulps), masks equal. ``propagate`` runs five ticks from a state with a
random padded covariance, the first tick through the constructor's null
state; every leaf of the state within 1e-12 of JAX, counters equal. All JAX
results come from one jitted call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from msckf_tpu.config import reference_experiment_config as jax_config
from msckf_tpu.filter import propagation as jprop
from msckf_tpu.ops import camera as jcam
from msckf_tpu.ops import geometry as jgeo

import msckf_tpu_torch as mt
from msckf_tpu_torch.filter import propagation as tprop
from msckf_tpu_torch.ops import camera as tcam
from msckf_tpu_torch.ops import geometry as tgeo

from tests.test_torch_modules import jax_state_from_numpy, jax_state_to_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-12
CAPS = dict(dtype="float64", f_max=32, u_max=8, k_max=32, m_max=4, n_cam_slots=4,
            max_camera_states=3, desc_dim=10)
TICKS = 5


def _inputs(rng):
    B = (4, 5)
    R = Rotation.random(20, random_state=1).as_matrix().reshape(B + (3, 3))
    Rb = Rotation.random(20, random_state=2).as_matrix().reshape(B + (3, 3))
    # one rotation for each case of Shepperd's method (trace, then each
    # diagonal entry largest)
    cases = Rotation.from_rotvec([[0.1, 0.2, 0.3], [3.0, 0.1, 0.1], [0.1, 3.0, 0.1],
                                  [0.1, 0.1, 3.0]]).as_matrix()
    acc = rng.normal(size=(6, 3)) + np.array([0.0, 0.0, 9.8])
    acc[4] = [0.0, 0.0, 9.81]  # aligned with gravity: the identity guard
    acc[5] = [0.0, 0.0, -9.81]  # opposed: the -identity guard
    pts = rng.normal(size=B + (3,)) + np.array([0.0, 0.0, 3.0])
    pts[0, :2, 2] = -1.0  # behind the camera
    pts[1, 0] = [40.0, 0.0, 1.0]  # out of the field of view
    return dict(
        R=R, t=rng.normal(size=B + (3,)), Rb=Rb, tb=rng.normal(size=B + (3,)),
        p=rng.normal(size=B + (3,)), v=rng.normal(size=B + (3,)) * 4.0,
        d2=rng.normal(size=B + (3,)), noisy=R + 1e-3 * rng.normal(size=B + (3, 3)),
        q=rng.normal(size=B + (4,)), euler=rng.uniform(-1.4, 1.4, B + (3,)),
        R4=np.concatenate([cases, R.reshape(-1, 3, 3)]), acc=acc,
        g=np.array([0.0, 0.0, 9.81]), pts=pts, pix=rng.uniform(0, 640, B + (2,)),
        K=np.array([[180.0, 0.0, 320.0], [0.0, 185.0, 240.0], [0.0, 0.0, 1.0]]),
    )


def _geometry(m, cam, x, align):
    """Every public geometry and camera function of module ``m`` / ``cam``."""
    out = {}
    out["compose_R"], out["compose_t"] = m.iso_compose(x["R"], x["t"], x["Rb"], x["tb"])
    out["inverse_R"], out["inverse_t"] = m.iso_inverse(x["R"], x["t"])
    out["apply"] = m.iso_apply(x["R"], x["t"], x["p"])
    out["rotate"] = m.iso_rotate(x["R"], x["p"])
    out["normalize"] = m.normalize(x["v"])
    out["angle"] = m.angle_between_directions(x["v"], x["d2"])
    out["gravity_align"] = align(x["acc"], x["g"])
    out["svd"] = m.svd_orthonormalize(x["noisy"])
    out["quat_to_R"] = m.quat_to_R(x["q"])
    out["R_to_quat"] = m.R_to_quat(x["R4"])
    out["euler_to_R"] = m.euler_xyz_intrinsic_to_R(x["euler"])
    out["R_to_euler"] = m.R_to_euler_xyz_intrinsic(x["R"])
    Kinv = x["Kinv"]
    out["proj_valid"], out["proj_uv"] = cam.project_point(x["K"], 640, 480, x["pts"])
    out["inv_proj"] = cam.inverse_project_point(Kinv, x["pix"])
    out["c2w"] = cam.cam_to_world(x["R"], x["t"], x["p"])
    out["c2w_versor"] = cam.cam_to_world(x["R"], x["t"], x["p"], is_versor=True)
    out["w2c"] = cam.world_to_cam(x["R"], x["t"], x["p"])
    out["w2c_versor"] = cam.world_to_cam(x["R"], x["t"], x["p"], is_versor=True)
    out["H_x"], out["H_f"] = cam.measurement_jacobians(x["R"], x["pts"])
    return out


def _imu(rng):
    gyro = rng.normal(size=(TICKS, 3)) * 0.2
    gyro[2] = 0.0  # a tick without rotation: the identity increment
    acc = rng.normal(size=(TICKS, 3)) + np.array([0.0, 0.0, 9.8])
    return gyro, acc, 1.0 + 0.005 * np.arange(1, TICKS + 1)


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(0)
    x = _inputs(rng)
    x["Kinv"] = np.linalg.inv(x["K"])
    gyro, acc, ts = _imu(rng)
    cfg = mt.reference_experiment_config(**CAPS)
    state = mt.make_initial_state(cfg, Rotation.from_rotvec([0.1, -0.2, 0.3]).as_matrix(),
                                  device="cpu")
    A = rng.normal(size=(cfg.err_dim, cfg.err_dim)) * 0.1
    P = A @ A.T + 1e-3 * np.eye(cfg.err_dim)
    state = state.replace(P=torch.as_tensor(P))
    start = mt.state_to_numpy(state)

    jcfg = jax_config(**CAPS)

    @jax.jit
    def jax_all(xj, st):
        out = _geometry(jgeo, jcam, xj, jax.vmap(jgeo.gravity_align_rotation, (0, None)))
        imu = st.imu
        out["nominal"] = jnp.concatenate([a.reshape(-1) for a in jprop.integrate_nominal(
            imu, xj["acc"][0], xj["gyro"][0], jnp.asarray(0.005), xj["g"])])
        states = []
        for i in range(TICKS):
            st = jprop.propagate(jcfg, st, xj["gyro"][i], xj["imu_acc"][i], xj["ts"][i])
            states.append(st)
        return out, states

    xj = {k: jnp.asarray(v) for k, v in x.items()}
    xj.update(gyro=jnp.asarray(gyro), imu_acc=jnp.asarray(acc), ts=jnp.asarray(ts))
    jout, jstates = jax_all(xj, jax_state_from_numpy(jcfg, start))

    xt = {k: torch.as_tensor(v) for k, v in x.items()}
    tout = _geometry(tgeo, tcam, xt, tgeo.gravity_align_rotation)
    imu = state.imu
    tout["nominal"] = torch.cat([a.reshape(-1) for a in tprop.integrate_nominal(
        imu, xt["acc"][0], torch.as_tensor(gyro[0]), torch.tensor(0.005, dtype=torch.float64),
        xt["g"])])
    tstates = []
    st = state
    for i in range(TICKS):
        st = mt.propagate(cfg, st, gyro[i], acc[i], ts[i], device="cpu")
        tstates.append(st)
    return (tout, jout), (tstates, jstates)


def test_geometry_and_camera_match_jax(both):
    (tout, jout), _ = both
    assert tout.keys() == jout.keys()
    for k, want in jout.items():
        got = tout[k].numpy()
        want = np.asarray(want)
        assert got.shape == want.shape, k
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=k)
    valid = tout["proj_valid"].numpy()
    assert valid.any() and not valid.all()
    ga = tout["gravity_align"].numpy()
    np.testing.assert_array_equal(ga[4], np.eye(3))
    np.testing.assert_array_equal(ga[5], -np.eye(3))


def test_propagate_matches_jax(both):
    _, (tstates, jstates) = both
    for i, (t, j) in enumerate(zip(tstates, jstates)):
        got, want = mt.state_to_numpy(t), jax_state_to_numpy(j)
        assert got.keys() == want.keys()
        for k, w in want.items():
            if np.issubdtype(w.dtype, np.floating):
                np.testing.assert_allclose(got[k], w, rtol=0, atol=TOL,
                                           err_msg=f"tick {i}: {k}")
            else:
                np.testing.assert_array_equal(got[k], w, err_msg=f"tick {i}: {k}")
    assert int(tstates[-1].imu.prop_count) == TICKS
    P = tstates[-1].P.numpy()
    np.testing.assert_array_equal(P, P.T)


def test_propagate_is_exported_and_takes_the_device_rule(monkeypatch, both):
    assert "propagate" in mt.__all__ and mt.propagate is tprop.propagate
    _, (tstates, _) = both
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.propagate(mt.reference_experiment_config(**CAPS), tstates[0], np.zeros(3),
                     np.zeros(3), 2.0)
