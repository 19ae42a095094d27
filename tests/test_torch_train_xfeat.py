"""The port's XFeat trainer against the JAX package's, on the CPU.

In float64 (x64 on, ``tests/conftest.py``), with Flax-initialized weights
carried across by ``state_dict_from_flax`` (float32 values, cast to float64
on both sides):

* ``BasicLayer``'s batch-statistics branch against Flax's
  ``BasicLayer(train=True)``: output, gradients and the new running
  statistics within 1e-12 relative;
* ``pair_losses`` on seeded feature maps and random homographies that send
  cells out of img2: the three losses and their gradients with respect to
  both descriptor maps, both logit maps and the reliability map within
  1e-10 relative, the valid counts exact;
* ``batch_loss`` at 64 x 64, batch 2: loss, aux, the gradient of every
  parameter (HWIO against OIHW) and the new batch statistics within 1e-9
  of each tensor's scale, read from the JAX package's ``make_train_step``
  with a chain that first stores the raw gradients;
* ``ClippedAdamW`` against optax's chain on the same float64 gradients (6
  steps, past the schedule's end, norms below and above the clip): 1e-12;
* two whole train steps against ``make_train_step``: losses, parameters and
  batch statistics within 1e-9 of each tensor's scale;

and in float32: the learning recipe of
``tests/test_xfeat_training.py::test_training_reduces_loss``; ``PairPool``
draws bitwise the JAX package's; ``save_npz_params`` writing the JAX
package's keys and arrays, read by the JAX package's loader and model within
1e-5; the ``--eval_every`` best-checkpoint rule; the CLI on the CPU.

Every JAX result comes from one jitted function (``_jax_reference``), so the
file pays for one compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msckf_tpu.models import train_xfeat as jtx
from msckf_tpu.models import xfeat as jxf
from msckf_tpu.models.selfsup import random_homography

from msckf_tpu_torch.models import train_xfeat as ttx
from msckf_tpu_torch.models import xfeat as txf

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZE, BATCH = 64, 2
LR, STEPS = 1e-3, 2  # two whole steps: the schedule's first and last rates
PL_SIZE = 48  # the image side of the pair-loss case (6 x 5 cells used)
OPT_LR, OPT_STEPS = 2e-2, 4  # the optimizer case: six steps on a four-step schedule


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _port_name(path) -> str:
    keys = [p.key for p in path]
    return ".".join(keys[:-1]) + (".weight" if keys[-1] == "kernel" else "." + keys[-1])


def _hwio(t: torch.Tensor) -> np.ndarray:
    """A port tensor in the JAX package's layout (OIHW kernels to HWIO)."""
    a = t.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


def _homographies(rng, B, S):
    """Random homographies (the training distribution) whose img1 cells
    partly leave img2: the first shifted by a third of the image."""
    Hs = [random_homography(rng, S) for _ in range(B)]
    Hs[0] = np.array([[1.0, 0.0, S / 3], [0.0, 1.0, -S / 4], [0.0, 0.0, 1.0]]) @ Hs[0]
    return np.stack(Hs)


def _moved_model() -> txf.XFeatModel:
    """A port model whose running statistics are away from 0 and 1."""
    model = txf.init_params(torch.Generator().manual_seed(3), device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) + (0.5 if name.endswith("var") else -0.5))
    return model


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The seeded numpy inputs of every comparison in this file."""
    rng = np.random.default_rng(0)
    bl = dict(x=rng.normal(size=(3, 10, 12, 5)) * 2.0 + 0.5, cot=rng.normal(size=(3, 5, 6, 8)),
              bn_mean=rng.normal(size=8), bn_var=rng.uniform(0.5, 2.0, size=8))
    B, hc, wc, C = 3, 6, 5, 8
    f1, f2 = rng.normal(size=(2, B, hc, wc, C))
    k1, k2 = rng.normal(size=(2, B, hc, wc, 65)) * 2.0
    l1, l2 = rng.integers(0, 65, size=(2, B, hc, wc)).astype(np.int32)
    pl = dict(f1=f1, f2=f2, k1=k1, k2=k2, rel=rng.uniform(size=(B, hc, wc)), l1=l1, l2=l2,
              H=_homographies(rng, B, PL_SIZE), w=rng.uniform(0.5, 1.5, size=(3, B)))
    pool = jtx.PairPool(np.random.default_rng(5), 3, SIZE)
    draws = [pool.draw(BATCH) for _ in range(STEPS)]
    # (img1, img2, H, labels1, labels2), each stacked over the steps
    batches = tuple(np.stack([d[i] for d in draws]) for i in range(5))
    batches = tuple(a.astype(np.float64) if a.dtype.kind == "f" else a for a in batches)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 2, 3)}
    # the global norm is below the clip at steps 0, 2 and 5 and above it else
    scales = (0.1, 3.0, 0.05, 40.0, 2.0, 0.2)
    opt = dict(p0={k: rng.normal(size=s) for k, s in shapes.items()},
               gs=[{k: rng.normal(size=s) * sc / 5.0 for k, s in shapes.items()}
                   for sc in scales])
    path = str(tmp_path_factory.mktemp("moved") / "moved.npz")
    ttx.save_npz_params(path, _moved_model())
    moved = dict(tree=jtx.load_npz_params(path),
                 img=rng.uniform(0, 255, (SIZE, SIZE)).astype(np.float32))
    return dict(bl=bl, pl=pl, batches=batches, opt=opt, moved=moved)


def _grad_capture():
    """A transformation that stores the raw gradients in its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def _jax_reference(case):
    """Every JAX-package result this file compares with, in one function
    (so one compile)."""
    out = {}
    bl = case["bl"]
    layer = jxf.BasicLayer(8, stride=2, train=True)
    params = jax.tree.map(lambda a: a.astype(jnp.float64),
                          layer.init(jax.random.key(1, impl="rbg"), bl["x"])["params"])
    stats = {"bn_mean": bl["bn_mean"], "bn_var": bl["bn_var"]}

    def f(params, xx):
        y, upd = layer.apply({"params": params, "batch_stats": stats}, xx,
                             mutable=["batch_stats"])
        return jnp.sum(y * bl["cot"]), (y, upd["batch_stats"])

    (_, (y, new)), (g_params, g_x) = jax.value_and_grad(f, (0, 1), has_aux=True)(params, bl["x"])
    y_eval = jxf.BasicLayer(8, stride=2).apply({"params": params, "batch_stats": new}, bl["x"])
    out["bl"] = dict(kernel=params["conv"]["kernel"], y=y, stats=new,
                     g_kernel=g_params["conv"]["kernel"], g_x=g_x, y_eval=y_eval)

    pl = case["pl"]

    def losses(f1, f2, k1, k2, rel):
        d, k, r, nv = jax.vmap(lambda a, b, la, lb, ka, kb, ra, h: jtx.pair_losses(
            a, b, la, lb, ka, kb, ra, h, PL_SIZE))(f1, f2, pl["l1"], pl["l2"], k1, k2, rel,
                                                   pl["H"])
        w = pl["w"]
        return jnp.sum(w[0] * d + w[1] * k + w[2] * r), (d, k, r, nv)

    (_, (d, k, r, nv)), grads = jax.value_and_grad(losses, (0, 1, 2, 3, 4), has_aux=True)(
        pl["f1"], pl["f2"], pl["k1"], pl["k2"], pl["rel"])
    out["pl"] = dict(d=d, k=k, r=r, nv=nv, grads=grads)

    # Flax's initializers drawn from an "rbg" key (XLA's bit generator,
    # which compiles in half the time of threefry's)
    init = jxf.XFeatModel(train=True).init(jax.random.key(0, impl="rbg"),
                                           jnp.zeros((1, SIZE, SIZE, 1)))
    out["init"] = init
    tx = optax.chain(_grad_capture(), optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(LR, STEPS, alpha=0.05)))
    v64 = jax.tree.map(lambda a: a.astype(jnp.float64), init)
    step = jtx.make_train_step(tx, SIZE)

    def body(carry, batch):
        params, stats, opt_state, loss, aux = step(*carry, *batch)
        return (params, stats, opt_state), dict(loss=loss, aux=aux, grads=opt_state[0],
                                                params=params, stats=stats)

    carry = (v64["params"], v64["batch_stats"], tx.init(v64["params"]))
    _, out["steps"] = jax.lax.scan(body, carry, case["batches"])  # leading axis: the step

    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.cosine_decay_schedule(OPT_LR, OPT_STEPS, alpha=0.05)))
    p = case["opt"]["p0"]
    opt_state = tx.init(p)
    out["opt"] = []
    for g in case["opt"]["gs"]:
        upd, opt_state = tx.update(g, opt_state, p)
        p = optax.apply_updates(p, upd)
        out["opt"].append(p)

    moved = case["moved"]
    out["moved"] = jxf.XFeatModel().apply(moved["tree"], moved["img"][None, :, :, None])
    return out


@pytest.fixture(scope="module")
def ref(case):
    return jax.tree.map(np.asarray, jax.jit(_jax_reference)(case))


@pytest.fixture(scope="module")
def flax_vars(ref):
    """Flax's default initialization of XFeat (float32 weights)."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32), ref["init"])


def _port_model(flax_vars, dtype=torch.float64) -> txf.XFeatModel:
    m = txf.XFeatModel()
    m.load_state_dict(txf.state_dict_from_flax(flax_vars))
    return m.to(dtype)


def _t(a):
    return torch.as_tensor(np.array(a))


# --------------------------------------------------------------- BasicLayer


def test_basic_layer_train_branch_matches_flax(case, ref):
    bl, want = case["bl"], ref["bl"]
    port = txf.BasicLayer(5, 8, stride=2).double().train()
    with torch.no_grad():
        port.conv.weight.copy_(_t(want["kernel"]).permute(3, 2, 0, 1))
        port.bn_mean.copy_(_t(bl["bn_mean"]))
        port.bn_var.copy_(_t(bl["bn_var"]))
    xt = _t(bl["x"].transpose(0, 3, 1, 2)).requires_grad_()
    y = port(xt)
    (y * _t(bl["cot"].transpose(0, 3, 1, 2))).sum().backward()

    assert _rel(y.detach().numpy().transpose(0, 2, 3, 1), want["y"]) <= 1e-12
    assert _rel(port.bn_mean, want["stats"]["bn_mean"]) <= 1e-12
    assert _rel(port.bn_var, want["stats"]["bn_var"]) <= 1e-12
    # gradients flow through the batch statistics
    assert _rel(_hwio(port.conv.weight.grad), want["g_kernel"]) <= 1e-12
    assert _rel(xt.grad.numpy().transpose(0, 2, 3, 1), want["g_x"]) <= 1e-12
    # eval mode normalizes by the running statistics and leaves them alone
    port.eval()
    before = port.bn_var.clone()
    with torch.no_grad():
        assert _rel(port(xt).numpy().transpose(0, 2, 3, 1), want["y_eval"]) <= 1e-12
    assert torch.equal(port.bn_var, before)


# -------------------------------------------------------------- pair losses


def test_pair_losses_and_gradients_match_jax(case, ref):
    pl, want = case["pl"], ref["pl"]
    hc, wc = pl["l1"].shape[1:]
    nchw = [_t(pl[k].transpose(0, 3, 1, 2)).requires_grad_() for k in ("f1", "f2", "k1", "k2")]
    rel = _t(pl["rel"]).requires_grad_()
    d, k, r, nv = ttx.pair_losses(nchw[0], nchw[1], _t(pl["l1"]), _t(pl["l2"]), nchw[2], nchw[3],
                                  rel, _t(pl["H"]))
    w = _t(pl["w"])
    (w[0] * d + w[1] * k + w[2] * r).sum().backward()

    np.testing.assert_array_equal(nv.numpy(), want["nv"])
    assert nv[0] < hc * wc and (nv > 0).all()  # cells of the shifted pair leave img2
    for got, key in ((d, "d"), (k, "k"), (r, "r")):
        assert _rel(got.detach(), want[key]) <= 1e-10, key
    for t, g in zip(nchw, want["grads"][:4]):
        assert _rel(t.grad.numpy().transpose(0, 2, 3, 1), g) <= 1e-10
    assert _rel(rel.grad, want["grads"][4]) <= 1e-10


# ------------------------------------------------- batch loss and train steps


def test_batch_loss_gradients_and_stats_match_jax(case, ref, flax_vars):
    model = _port_model(flax_vars)
    loss, aux = ttx.batch_loss(model, *(_t(a[0]) for a in case["batches"]))
    loss.backward()
    want = jax.tree.map(lambda a: a[0], ref["steps"])
    assert _rel(loss.detach(), want["loss"]) <= 1e-9
    for key in ("desc", "kp", "rel", "valid_cells"):
        assert _rel(aux[key].detach(), want["aux"][key]) <= 1e-9, key
    params = dict(model.named_parameters())
    grads = jax.tree_util.tree_leaves_with_path(want["grads"])
    assert len(grads) == len(params) == 23 + 4 * 2
    for path, g in grads:
        assert _rel(_hwio(params[_port_name(path)].grad), g) <= 1e-9, path
    bufs = dict(model.named_buffers())
    for path, s in jax.tree_util.tree_leaves_with_path(want["stats"]):
        assert _rel(bufs[_port_name(path)], s) <= 1e-9, path


def test_two_train_steps_match_jax(case, ref, flax_vars):
    model = _port_model(flax_vars)
    opt = ttx.ClippedAdamW(model.parameters(), LR, STEPS)
    worst = 0.0
    for i in range(STEPS):
        want = jax.tree.map(lambda a: a[i], ref["steps"])
        loss, _ = ttx.train_step(model, opt, *(_t(a[i]) for a in case["batches"]))
        worst = max(worst, _rel(loss, want["loss"]))
        sd = model.state_dict()
        for tree in (want["params"], want["stats"]):
            for path, a in jax.tree_util.tree_leaves_with_path(tree):
                worst = max(worst, _rel(_hwio(sd[_port_name(path)]), a))
    assert worst <= 1e-9, worst


def test_clipped_adamw_matches_optax_chain(case, ref):
    p0, gs = case["opt"]["p0"], case["opt"]["gs"]
    norms = [np.sqrt(sum((g ** 2).sum() for g in step.values())) for step in gs]
    assert min(norms) < 1.0 < max(norms) and len(gs) > OPT_STEPS
    pt = {k: _t(v).requires_grad_() for k, v in p0.items()}
    opt = ttx.ClippedAdamW(list(pt.values()), OPT_LR, OPT_STEPS)
    for g, want in zip(gs, ref["opt"]):
        for k, t in pt.items():
            t.grad = _t(g[k])
        opt.step()
        for k, t in pt.items():
            np.testing.assert_allclose(t.detach().numpy(), want[k], rtol=0, atol=1e-12)
    assert opt.count == 6 and opt.param_groups[0]["lr"] == pytest.approx(OPT_LR * 0.05,
                                                                          rel=1e-15)


def test_training_reduces_loss():
    """The recipe and criterion of tests/test_xfeat_training.py on the
    port's loop (float32, Adam 2e-3, no clip)."""
    size, batch, steps = 128, 2, 25
    pool = ttx.PairPool(np.random.default_rng(3), 8, size)
    model = txf.init_params(torch.Generator().manual_seed(0), device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=2e-3)
    losses = []
    for _ in range(steps):
        loss, _ = ttx.train_step(model, opt, *(torch.as_tensor(a) for a in pool.draw(batch)))
        losses.append(float(loss))
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert np.isfinite(last)
    assert last < first * 0.8, f"no learning: {first:.3f} -> {last:.3f}"


# ------------------------------------------------------- pool, weights, CLI


def test_pair_pool_draws_bitwise_and_round_trips(tmp_path):
    pj = jtx.PairPool(np.random.default_rng(9), 3, SIZE)
    pt = ttx.PairPool(np.random.default_rng(9), 3, SIZE)
    for step in range(3):
        for a, b in zip(pt.draw(2), pj.draw(2)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        pt.refresh(1)
        pj.refresh(1)
    pt.save(str(tmp_path / "pool.npz"))
    back = ttx.PairPool.from_file(np.random.default_rng(1), str(tmp_path / "pool.npz"))
    jback = jtx.PairPool.from_file(np.random.default_rng(1), str(tmp_path / "pool.npz"))
    assert back.size == SIZE
    np.testing.assert_array_equal(back.img1, pt.img1.astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(back.l2, pt.l2)
    for a, b in zip(back.draw(2), jback.draw(2)):
        np.testing.assert_array_equal(a, b)


def test_save_npz_params_is_the_jax_layout(case, ref, flax_vars, tmp_path):
    jtx.save_npz_params(str(tmp_path / "jax.npz"), flax_vars)
    ttx.save_npz_params(str(tmp_path / "port.npz"), _port_model(flax_vars, torch.float32))
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert set(a.files) == set(b.files) and len(a.files) == 23 * 3 + 4 * 2
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # a port model with moved statistics, saved by the port and run by the
    # JAX package's loader and model (the case fixture)
    with torch.no_grad():
        outs = _moved_model()(_t(case["moved"]["img"])[None, None])
    for got, want in zip(outs, ref["moved"]):
        assert _rel(got.numpy(), want.transpose(0, 3, 1, 2)) <= 1e-5


def test_eval_every_keeps_the_best_checkpoint(monkeypatch, tmp_path):
    precs = iter([0.3, 0.3, 0.5, 0.5, 0.4, 0.4])  # (hard, mild) of each eval
    snapshots = []

    def fake_accuracy(model, rng, hard=False, **kw):
        assert not model.training
        if hard:
            snapshots.append({k: v.clone() for k, v in model.state_dict().items()})
        return next(precs), 100.0

    monkeypatch.setattr(ttx, "match_accuracy", fake_accuracy)
    out = str(tmp_path / "best.npz")
    model, log = ttx.train(steps=3, batch=2, size=SIZE, pool_pairs=2, refresh_every=2,
                           refresh_n=1, eval_every=1, out=out, device="cpu")
    assert len(snapshots) == 3 and log.losses.shape == (3,) and not model.training
    best = snapshots[1]
    for k, v in model.state_dict().items():
        assert torch.equal(v, best[k]), k
    saved = txf.load_xfeat_npz(out, device="cpu").state_dict()
    for k, v in saved.items():
        assert torch.equal(v, best[k]), k


def test_main_on_the_cpu_writes_weights_both_packages_load(tmp_path, capsys):
    out = str(tmp_path / "w" / "x.npz")
    ttx.main(["--device", "cpu", "--steps", "2", "--size", "64", "--batch", "2", "--pool", "2",
              "--out", out])
    assert "weights saved" in capsys.readouterr().out
    port = txf.load_xfeat_npz(out, device="cpu")
    tree = jtx.load_npz_params(out)
    assert set(tree) == {"params", "batch_stats"}
    ref = txf.state_dict_from_flax(jax.tree.map(np.asarray, tree))
    for k, v in port.state_dict().items():
        assert torch.equal(v, ref[k]), k
    # and --resume continues from it
    ttx.main(["--device", "cpu", "--steps", "1", "--size", "64", "--batch", "2", "--pool", "2",
              "--out", str(tmp_path / "y.npz"), "--resume", out])
    assert txf.load_xfeat_npz(str(tmp_path / "y.npz"), device="cpu") is not None
