"""The port's frozen front-end benchmark against the JAX package's.

* ``generate_fixture_v1`` on the port's ``make_batch`` reproduces every
  array of the committed ``weights/frontend_eval_v1.npz`` bitwise (arrays,
  not file bytes: zip metadata may differ), written to a temporary path;
* ``fixture_sha256`` gives the hash ``tests/test_xfeat_frozen_eval.py``
  pins;
* ``pair_match_stats`` on two frozen pairs and ``match_accuracy`` on two
  mild pairs equal the JAX package's, with the committed weights
  (``weights/xfeat_selfsup.npz``);
* ``frozen_match_precision`` with the committed weights holds the JAX
  test's gates (hard >= 0.60, mild >= 0.52, >= 60 matches a pair).
"""

from pathlib import Path

import numpy as np
import pytest

from msckf_tpu.models import frontend_eval as jfe
from msckf_tpu.models import train_xfeat as jtx

from msckf_tpu_torch.models import frontend_eval as tfe
from msckf_tpu_torch.models import train_xfeat as ttx
from msckf_tpu_torch.models.xfeat import load_xfeat_npz

from tests.test_xfeat_frozen_eval import FIXTURE_V1_SHA256, GATE_HARD, GATE_MILD
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "xfeat_selfsup.npz"


@pytest.fixture(scope="module")
def model():
    return load_xfeat_npz(str(WEIGHTS), device="cpu")


def test_fixture_is_the_pinned_file():
    assert Path(tfe.FIXTURE_V1) == Path(jfe.FIXTURE_V1)
    assert tfe.fixture_sha256() == FIXTURE_V1_SHA256
    assert (tfe.TOP_K, tfe.TOL_PX) == (jfe.TOP_K, jfe.TOL_PX)


def test_generate_fixture_v1_reproduces_the_committed_arrays(tmp_path):
    path = tmp_path / "v1.npz"
    tfe.generate_fixture_v1(str(path))
    with np.load(tfe.FIXTURE_V1) as want, np.load(path) as got:
        assert set(got.files) == set(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tfe.fixture_sha256() == FIXTURE_V1_SHA256  # the committed file is untouched


def test_pair_match_stats_and_match_accuracy_match_jax(model):
    variables = jtx.load_npz_params(str(WEIGHTS))
    with np.load(tfe.FIXTURE_V1) as data:
        pairs = [(data["hard_img1"][b].astype(np.float32), data["hard_img2"][b].astype(np.float32),
                  data["hard_H"][b]) for b in range(2)]
    for img1, img2, H in pairs:
        got = tfe.pair_match_stats(model, img1, img2, H)
        assert got == jfe.pair_match_stats(variables, img1, img2, H)
        assert got[1] >= 20
    got = ttx.match_accuracy(model, np.random.default_rng(999), n_pairs=2)
    assert got == jtx.match_accuracy(variables, np.random.default_rng(999), n_pairs=2)


def test_committed_weights_hold_the_frozen_gates_on_the_port(model):
    hard_prec, hard_n = tfe.frozen_match_precision(model, hard=True)
    mild_prec, mild_n = tfe.frozen_match_precision(model, hard=False)
    assert hard_prec >= GATE_HARD, hard_prec
    assert mild_prec >= GATE_MILD, mild_prec
    assert hard_n >= 60 and mild_n >= 60, (hard_n, mild_n)
