"""The port's 35 optimizer update ops (``ops/optimizer_ops.py``): the cases
of the reference's ``tests/test_optimizer_ops.py`` (each op against numpy
or against the Optimizer class it implements), run in both packages, and
every ``multi_*``/``preloaded_multi_*`` form against its single form. Each
op's own case against the JAX package is in ``tools/op_cases.py``
(``tests/test_torch_ops.py``).

Tolerances are the reference test's: 1e-6 relative where the op repeats
numpy's arithmetic, 1e-5 against an Optimizer class's update (a different
order of the same f32 operations); the multi forms run their single
form's arithmetic group by group, so they are held bitwise.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))

PACKAGES = {"port": mt, "reference": mx}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    if request.param == "port":
        with mt.cpu():
            yield mt
    else:
        yield mx


def _rand(shape, seed, dtype="float32"):
    return onp.random.RandomState(seed).rand(*shape).astype(dtype)


def _state(opt, w):
    return opt.create_state_multi_precision(0, w)


def test_sgd_update_matches_numpy(pkg):
    nd = pkg.nd
    w, g = _rand((3, 4), 0), _rand((3, 4), 1)
    out = nd.sgd_update(nd.array(w), nd.array(g), lr=0.1, wd=0.01,
                        rescale_grad=0.5)
    onp.testing.assert_allclose(out.asnumpy(), w - 0.1 * (0.5 * g + 0.01 * w),
                                rtol=1e-6)


def test_sgd_mom_update_trajectory_matches_class(pkg):
    nd = pkg.nd
    w0, g = _rand((5,), 2), _rand((5,), 3)
    opt = pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=0.0)
    wc = nd.array(w0)
    state = _state(opt, wc)
    w_op, m_op = nd.array(w0), nd.zeros((5,))
    for _ in range(3):
        opt.update(0, wc, nd.array(g), state)
        w_op, m_op = nd.sgd_mom_update(w_op, nd.array(g), m_op, lr=0.1,
                                       momentum=0.9)
    onp.testing.assert_allclose(w_op.asnumpy(), wc.asnumpy(), rtol=1e-5)


def test_clip_gradient_applies_before_wd(pkg):
    nd = pkg.nd
    w, g = onp.ones((4,), "float32"), onp.full((4,), 10.0, "float32")
    out = nd.sgd_update(nd.array(w), nd.array(g), lr=1.0, wd=0.5,
                        clip_gradient=1.0)
    onp.testing.assert_allclose(out.asnumpy(), w - (1.0 + 0.5 * w), rtol=1e-6)


def test_adam_update_no_bias_correction(pkg):
    nd = pkg.nd
    w, g = _rand((3,), 4), _rand((3,), 5)
    z = onp.zeros(3, "float32")
    nw, nm, nv = nd.adam_update(nd.array(w), nd.array(g), nd.array(z),
                                nd.array(z), lr=0.01)
    em, ev = 0.1 * g, 0.001 * g * g
    onp.testing.assert_allclose(nm.asnumpy(), em, rtol=1e-5)
    onp.testing.assert_allclose(nv.asnumpy(), ev, rtol=1e-5)
    onp.testing.assert_allclose(nw.asnumpy(),
                                w - 0.01 * em / (onp.sqrt(ev) + 1e-8),
                                rtol=1e-5)


def test_adamw_decoupled_wd(pkg):
    nd = pkg.nd
    w, z = _rand((3,), 6), onp.zeros(3, "float32")
    nw, _, _ = nd.adamw_update(nd.array(w), nd.array(z), nd.array(z),
                               nd.array(z), lr=0.1, eta=1.0, wd=0.5)
    onp.testing.assert_allclose(nw.asnumpy(), w - 0.5 * w, rtol=1e-5)


def test_mp_sgd_update_master_weights(pkg):
    nd = pkg.nd
    w16, g16 = _rand((4,), 7, "float16"), _rand((4,), 8, "float16")
    w32 = w16.astype("float32")
    nw, nw32 = nd.mp_sgd_update(nd.array(w16, dtype="float16"),
                                nd.array(g16, dtype="float16"),
                                nd.array(w32), lr=0.1)
    assert str(nw.dtype) == "float16" and str(nw32.dtype) == "float32"
    onp.testing.assert_allclose(nw32.asnumpy(),
                                w32 - 0.1 * g16.astype("float32"), rtol=1e-6)
    onp.testing.assert_array_equal(nw.asnumpy(),
                                   nw32.asnumpy().astype("float16"))


def test_ftrl_update_matches_class(pkg):
    nd = pkg.nd
    w0, g = _rand((6,), 9), _rand((6,), 10)
    opt = pkg.optimizer.Ftrl(learning_rate=0.1, lamda1=0.01, beta=1.0,
                             wd=0.0)
    wc = nd.array(w0)
    state = _state(opt, wc)
    w_op, z, n = nd.array(w0), nd.zeros((6,)), nd.zeros((6,))
    for _ in range(2):
        opt.update(0, wc, nd.array(g), state)
        w_op, z, n = nd.ftrl_update(w_op, nd.array(g), z, n, lr=0.1,
                                    lamda1=0.01, beta=1.0)
    onp.testing.assert_allclose(w_op.asnumpy(), wc.asnumpy(), rtol=1e-5,
                                atol=1e-7)


def test_rmspropalex_centered_matches_class(pkg):
    nd = pkg.nd
    w0, g = _rand((4,), 11), _rand((4,), 12)
    opt = pkg.optimizer.RMSProp(learning_rate=0.05, rho=0.95, momentum=0.9,
                                centered=True, wd=0.0)
    wc = nd.array(w0)
    state = _state(opt, wc)
    w_op, n, ga, delta = nd.array(w0), nd.zeros((4,)), nd.zeros((4,)), \
        nd.zeros((4,))
    for _ in range(3):
        opt.update(0, wc, nd.array(g), state)
        w_op, n, ga, delta = nd.rmspropalex_update(
            w_op, nd.array(g), n, ga, delta, lr=0.05, gamma1=0.95,
            gamma2=0.9)
    onp.testing.assert_allclose(w_op.asnumpy(), wc.asnumpy(), rtol=1e-4)


def test_lamb_two_phase_matches_class(pkg):
    nd = pkg.nd
    w0, g = _rand((8,), 13), _rand((8,), 14)
    opt = pkg.optimizer.LAMB(learning_rate=0.01, wd=0.1)
    wc = nd.array(w0)
    opt.update(0, wc, nd.array(g), _state(opt, wc))
    gp, _, _ = nd.lamb_update_phase1(nd.array(w0), nd.array(g),
                                     nd.zeros((8,)), nd.zeros((8,)), t=1,
                                     wd=0.1)
    r1 = nd.array(onp.array(onp.linalg.norm(w0), "float32"))
    r2 = nd.array(onp.array(onp.linalg.norm(gp.asnumpy()), "float32"))
    w_op = nd.lamb_update_phase2(nd.array(w0), gp, r1, r2, lr=0.01)
    onp.testing.assert_allclose(w_op.asnumpy(), wc.asnumpy(), rtol=1e-5)


def test_group_adagrad_row_sharing(pkg):
    nd = pkg.nd
    w, g = _rand((3, 4), 15), _rand((3, 4), 16)
    nw, nh = nd.group_adagrad_update(nd.array(w), nd.array(g),
                                     nd.zeros((3,)), lr=0.1)
    want_h = (g ** 2).mean(axis=1)
    onp.testing.assert_allclose(nh.asnumpy(), want_h, rtol=1e-5)
    onp.testing.assert_allclose(
        nw.asnumpy(), w - 0.1 * g / (onp.sqrt(want_h)[:, None] + 1e-5),
        rtol=1e-5)


def test_sparse_adagrad_only_touches_rows(pkg):
    nd = pkg.nd
    w, gv = _rand((5, 3), 17), _rand((2, 3), 18)
    nw, nh = nd.sparse_adagrad_update(
        nd.array(w), nd.array(gv), nd.array(onp.array([1, 3], "float32")),
        nd.zeros((5, 3)), lr=0.1)
    nw, nh = nw.asnumpy(), nh.asnumpy()
    onp.testing.assert_array_equal(nw[[0, 2, 4]], w[[0, 2, 4]])
    assert not onp.allclose(nw[[1, 3]], w[[1, 3]])
    onp.testing.assert_allclose(nh[[1, 3]], gv ** 2, rtol=1e-6)


def test_multi_lars_rates(pkg):
    nd = pkg.nd
    out = nd.multi_lars(nd.array(onp.array([0.1, 0.1], "float32")),
                        nd.array(onp.array([4.0, 0.0], "float32")),
                        nd.array(onp.array([1.0, 1.0], "float32")),
                        nd.zeros((2,)), eta=0.001, eps=0.0).asnumpy()
    onp.testing.assert_allclose(out[0], 0.1 * 0.001 * 2.0, rtol=1e-6)
    onp.testing.assert_allclose(out[1], 0.1, rtol=1e-6)   # passed through


def test_signum_and_nag(pkg):
    nd = pkg.nd
    w, g = _rand((4,), 70), _rand((4,), 71)
    m = nd.zeros((4,))
    nw, nm = nd.signum_update(nd.array(w), nd.array(g), m, lr=0.1,
                              momentum=0.9)
    onp.testing.assert_allclose(nm.asnumpy(), -0.1 * g, rtol=1e-6)
    onp.testing.assert_allclose(nw.asnumpy(), w + 0.1 * onp.sign(-0.1 * g),
                                rtol=1e-6)
    nw2, _ = nd.nag_mom_update(nd.array(w), nd.array(g), m, lr=0.1,
                               momentum=0.9)
    onp.testing.assert_allclose(nw2.asnumpy(), w - 0.1 * (g + 0.9 * g),
                                rtol=1e-6)


def test_multi_mp_lamb_update_runs_and_descends(pkg):
    nd = pkg.nd
    rng = onp.random.RandomState(1)
    w32 = rng.randn(6, 3).astype("float32")
    z = onp.zeros_like(w32)
    outs = nd.multi_mp_lamb_update(
        nd.array(w32, dtype="float16"), nd.array(onp.full_like(w32, 0.5)),
        nd.array(z), nd.array(z), nd.array(w32), lrs=(0.01,), wds=(0.0,),
        num_weights=1, step_count=(1,))
    assert len(outs) == 4
    nw32 = outs[3].asnumpy()
    assert onp.isfinite(nw32).all() and not onp.allclose(nw32, w32)
    onp.testing.assert_array_equal(outs[0].asnumpy(),
                                   nw32.astype("float16"))


# ---------------------------------------------------------------------------
# every multi form against its single form, group by group (the port)
# ---------------------------------------------------------------------------
LRS, WDS, ETAS, STEPS = (0.1, 0.05, 0.2), (0.0, 0.01, 0.02), \
    (1.0, 0.5, 0.25), (1, 2, 3)
CLIP = dict(rescale_grad=0.5, clip_gradient=0.4)


def _group(seed, per, half):
    """(w, g, states..., [master]) as numpy: the weight and gradient
    fp16 and a master last when ``half``, second moments positive."""
    rng = onp.random.RandomState(seed)
    ts = [rng.randn(3, 4).astype("float32") for _ in range(per)]
    if per >= 4:
        ts[3] = rng.uniform(0.1, 1.0, (3, 4)).astype("float32")
    if half:
        ts[-1] = ts[0]
        return [ts[0].astype("float16"), ts[1].astype("float16")] + ts[2:]
    return ts


def _nd(arrs):
    nd = mt.nd
    return [nd.array(a, dtype=str(a.dtype)) for a in arrs]


def _single(name, group, i):
    nd = mt.nd
    w, g = group[0], group[1]
    if name in ("multi_sgd_update", "preloaded_multi_sgd_update"):
        return [nd.sgd_update(w, g, lr=LRS[i], wd=WDS[i], **CLIP)]
    if name in ("multi_sgd_mom_update", "preloaded_multi_sgd_mom_update"):
        return nd.sgd_mom_update(w, g, group[2], lr=LRS[i], momentum=0.9,
                                 wd=WDS[i], **CLIP)
    if name in ("multi_mp_sgd_update", "preloaded_multi_mp_sgd_update"):
        return nd.mp_sgd_update(w, g, group[2], lr=LRS[i], wd=WDS[i], **CLIP)
    if name in ("multi_mp_sgd_mom_update",
                "preloaded_multi_mp_sgd_mom_update"):
        return nd.mp_sgd_mom_update(w, g, group[2], group[3], lr=LRS[i],
                                    momentum=0.9, wd=WDS[i], **CLIP)
    if name == "multi_adamw_update":
        return nd.adamw_update(*group, lr=LRS[i], eta=ETAS[i], wd=WDS[i],
                               **CLIP)
    if name == "multi_mp_adamw_update":
        return nd.mp_adamw_update(*group, lr=LRS[i], eta=ETAS[i], wd=WDS[i],
                                  **CLIP)
    # the LAMB forms: phase 1, the norms, phase 2 (on the master for mp)
    master = group[4] if name == "multi_mp_lamb_update" else w
    gp, m, v = nd.lamb_update_phase1(master, g.astype("float32"), group[2],
                                     group[3], t=STEPS[i], wd=WDS[i], **CLIP)
    r1, r2 = nd.norm(master), nd.norm(gp)
    nw = nd.lamb_update_phase2(master, gp, r1, r2, lr=LRS[i])
    if name == "multi_mp_lamb_update":
        return [nw.astype("float16"), m, v, nw]
    return [nw, m, v]


MULTI = {  # name: (tensors per group, fp16 weights with a master)
    "multi_sgd_update": (2, False), "multi_sgd_mom_update": (3, False),
    "multi_mp_sgd_update": (3, True), "multi_mp_sgd_mom_update": (4, True),
    "preloaded_multi_sgd_update": (2, False),
    "preloaded_multi_sgd_mom_update": (3, False),
    "preloaded_multi_mp_sgd_update": (3, True),
    "preloaded_multi_mp_sgd_mom_update": (4, True),
    "multi_adamw_update": (4, False), "multi_mp_adamw_update": (5, True),
    "multi_lamb_update": (4, False), "multi_mp_lamb_update": (5, True)}


@pytest.mark.parametrize("name", sorted(MULTI))
def test_multi_form_equals_its_single_form(name):
    per, half = MULTI[name]
    with mt.cpu():
        groups = [_nd(_group(80 + i, per, half)) for i in range(3)]
        flat = [t for grp in groups for t in grp]
        attrs = dict(num_weights=3, **CLIP)
        if name.startswith("preloaded"):
            flat += [mt.nd.array(onp.array(LRS, "float32")),
                     mt.nd.array(onp.array(WDS, "float32"))]
        else:
            attrs.update(lrs=LRS, wds=WDS)
        if "adamw" in name:
            attrs["etas"] = ETAS
        if "lamb" in name:
            attrs["step_count"] = STEPS
        if "mom" in name:
            attrs["momentum"] = 0.9
        outs = getattr(mt.nd, name)(*flat, **attrs)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        want = [t for i, grp in enumerate(groups)
                for t in _single(name, grp, i)]
    assert len(outs) == len(want)
    for k, (a, b) in enumerate(zip(outs, want)):
        assert a.dtype == b.dtype, k
        if "lamb" in name:   # nd.norm vs the op's vector norm: sum order
            onp.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6,
                                        atol=1e-7, err_msg=str(k))
        else:
            onp.testing.assert_array_equal(a.asnumpy(), b.asnumpy(),
                                           err_msg=str(k))


def test_the_35_ops_are_the_references():
    """The port registers exactly the reference's optimizer ops."""
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry as reg
    ref = {n for n in jreg.list_ops()
           if jreg.get_op(n).fn.__module__ == "mxnet_tpu.ops.optimizer_ops"}
    port = {n for n in reg.list_ops()
            if reg.get_op(n).fn.__module__ ==
            "mxnet_tpu_torch.ops.optimizer_ops"}
    assert len(ref) == 35 and port == ref
    for n in port:
        assert not reg.get_op(n).differentiable
        assert callable(getattr(mt.nd, n))
