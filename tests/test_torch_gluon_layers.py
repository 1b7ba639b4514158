"""The Gluon layers and losses of the op-surface slice against the JAX
package on the CPU: ``RMSNorm``, ``GroupNorm``, ``InstanceNorm``,
``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``, ``Swish``,
``ReflectionPad2D``, ``Conv1D``/``Conv3D``, the pooling layers in 1-3 D
and their global forms, ``CTCLoss`` and ``SDMLLoss``: the same
constructor arguments, the JAX package's weights carried across, outputs
and structural parameter names compared (f32, 1e-5 relative). The
transposed convolutions are held to the port's ``Deconvolution`` op, which
test_torch_ops.py holds to the reference's convolution gradient (the
reference's own transposed layers apply the kernel with in and out
swapped; ROADMAP Queue 3)."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import carrier

torch.set_num_threads(2)
torch.exp(torch.zeros(1 << 18))

TOL = 1e-5


def _x(shape, seed=0):
    return onp.random.RandomState(seed).randn(*shape).astype(onp.float32)


LAYERS = {
    "RMSNorm": (lambda m: m.RMSNorm(), (2, 3, 4)),
    "GroupNorm": (lambda m: m.GroupNorm(num_groups=2), (2, 4, 3, 3)),
    "InstanceNorm": (lambda m: m.InstanceNorm(), (2, 3, 4, 5)),
    "InstanceNorm_scale": (lambda m: m.InstanceNorm(scale=True,
                                                    epsilon=1e-3),
                           (2, 3, 4, 5)),
    "LeakyReLU": (lambda m: m.LeakyReLU(0.2), (3, 4)),
    "PReLU": (lambda m: m.PReLU(in_channels=3), (2, 3, 4)),
    "ELU": (lambda m: m.ELU(0.7), (3, 4)),
    "SELU": (lambda m: m.SELU(), (3, 4)),
    "GELU": (lambda m: m.GELU(), (3, 4)),
    "GELU_tanh": (lambda m: m.GELU(approximation="tanh"), (3, 4)),
    "Swish": (lambda m: m.Swish(beta=1.5), (3, 4)),
    "ReflectionPad2D": (lambda m: m.ReflectionPad2D(2), (1, 2, 4, 5)),
    "Conv1D": (lambda m: m.Conv1D(4, 3, strides=2, padding=1,
                                  activation="relu"), (2, 3, 9)),
    "Conv2D_groups": (lambda m: m.Conv2D(4, (3, 2), groups=2, dilation=2,
                                         use_bias=False), (2, 4, 7, 6)),
    "Conv3D": (lambda m: m.Conv3D(3, 2, padding=(1, 0, 1)), (1, 2, 4, 5, 3)),
    "MaxPool1D": (lambda m: m.MaxPool1D(3, 2), (2, 3, 9)),
    "MaxPool2D_ceil": (lambda m: m.MaxPool2D(3, 2, ceil_mode=True),
                       (2, 3, 8, 7)),
    "MaxPool3D": (lambda m: m.MaxPool3D(), (1, 2, 4, 5, 6)),
    "AvgPool1D": (lambda m: m.AvgPool1D(3, 2, padding=1), (2, 3, 9)),
    "AvgPool2D_nopad": (lambda m: m.AvgPool2D(3, 2, padding=1,
                                              count_include_pad=False),
                        (2, 3, 8, 7)),
    "AvgPool3D": (lambda m: m.AvgPool3D(2, ceil_mode=True), (1, 2, 5, 5, 5)),
    "GlobalMaxPool1D": (lambda m: m.GlobalMaxPool1D(), (2, 3, 9)),
    "GlobalMaxPool2D": (lambda m: m.GlobalMaxPool2D(), (2, 3, 8, 7)),
    "GlobalMaxPool3D": (lambda m: m.GlobalMaxPool3D(), (1, 2, 4, 5, 6)),
    "GlobalAvgPool1D": (lambda m: m.GlobalAvgPool1D(), (2, 3, 9)),
    "GlobalAvgPool2D": (lambda m: m.GlobalAvgPool2D(), (2, 3, 8, 7)),
    "GlobalAvgPool3D": (lambda m: m.GlobalAvgPool3D(), (1, 2, 4, 5, 6)),
}


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_matches_the_jax_package(kind):
    make, shape = LAYERS[kind]
    x = _x(shape, 1) * 2
    mx.random.seed(0)
    ref = make(jnn)
    ref.initialize(mx.init.Uniform(0.5))
    want = ref(mx.nd.array(x)).asnumpy()
    named = {k: p.data().asnumpy()
             for k, p in ref._collect_params_with_prefix().items()}
    with mt.cpu():
        got = make(nn)
        if named:
            carrier.load_jax_params(got, named)
        out = got(mt.nd.array(x))
        assert sorted(got._collect_params_with_prefix()) == sorted(named)
    onp.testing.assert_allclose(out.asnumpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["1d", "2d", "3d_groups"])
def test_transposed_conv_layers_run_the_deconvolution_op(kind):
    make, shape, kw = {
        "1d": (lambda: nn.Conv1DTranspose(4, 3, strides=2, padding=1,
                                          output_padding=1), (2, 3, 5),
               dict(kernel=(3,), stride=(2,), pad=(1,), adj=(1,))),
        "2d": (lambda: nn.Conv2DTranspose(5, (3, 2), strides=(2, 1),
                                          dilation=(1, 2)), (2, 3, 4, 5),
               dict(kernel=(3, 2), stride=(2, 1), dilate=(1, 2))),
        "3d_groups": (lambda: nn.Conv3DTranspose(4, 2, strides=2, groups=2,
                                                 use_bias=False),
                      (1, 4, 2, 3, 2),
                      dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                           num_group=2, no_bias=True))}[kind]
    with mt.cpu():
        layer = make()
        layer.initialize(mt.init.Uniform(0.5))
        x = mt.nd.array(_x(shape, 2))
        out = layer(x)
        w = layer.weight.data()
        assert w.shape[0] == shape[1]             # (in, out / groups, *k)
        b = None if layer.bias is None else layer.bias.data()
        want = mt.nd.Deconvolution(x, w, b, **kw)
    onp.testing.assert_array_equal(out.asnumpy(), want.asnumpy())


def test_dropout_layer_shares_masks_along_axes():
    with mt.cpu():
        drop = nn.Dropout(0.5, axes=(1,))
        x = mt.nd.ones((8, 16))
        with mt.autograd.record():
            y = drop(x).asnumpy()
    assert ((y == y[:, :1]).all())
    assert 0 < (y[:, 0] == 0).sum() < 8


def _ctc_inputs():
    r = onp.random.RandomState(3)
    pred = r.randn(3, 6, 5).astype(onp.float32)           # NTC
    label = onp.float32([[0, 1, -1], [2, 2, 3], [1, -1, -1]])
    return pred, label


@pytest.mark.parametrize("lengths", [False, True])
def test_ctc_loss_matches_the_jax_package(lengths):
    pred, label = _ctc_inputs()
    extra = (onp.float32([6, 4, 5]), onp.float32([2, 3, 1])) if lengths \
        else ()
    want = mx.gluon.loss.CTCLoss()(mx.nd.array(pred), mx.nd.array(label),
                                   *[mx.nd.array(e) for e in extra])
    with mt.cpu():
        got = mt.gluon.loss.CTCLoss()(mt.nd.array(pred), mt.nd.array(label),
                                      *[mt.nd.array(e) for e in extra])
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=TOL,
                                atol=TOL)


def test_ctc_loss_tnc_layout_and_gradient():
    pred, label = _ctc_inputs()
    tnc = pred.transpose(1, 0, 2).copy()
    grads = []
    for pkg in (mx, mt):
        with pkg.cpu():
            p = pkg.nd.array(tnc)
            p.attach_grad()
            with pkg.autograd.record():
                loss = pkg.gluon.loss.CTCLoss(layout="TNC", label_layout="TN")(
                    p, pkg.nd.array(label.T.copy()))
            loss.backward()
            grads.append((loss.asnumpy(), p.grad.asnumpy()))
    for g, w in zip(grads[1], grads[0]):
        onp.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_sdml_loss_matches_the_jax_package():
    x1, x2 = _x((4, 3, 2), 4), _x((4, 3, 2), 5)
    want = mx.gluon.loss.SDMLLoss(smoothing_parameter=0.2)(
        mx.nd.array(x1), mx.nd.array(x2))
    with mt.cpu():
        got = mt.gluon.loss.SDMLLoss(smoothing_parameter=0.2)(
            mt.nd.array(x1), mt.nd.array(x2))
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=TOL,
                                atol=TOL)
