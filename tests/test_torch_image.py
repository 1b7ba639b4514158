"""The port's image path against the JAX package's, on the CPU:
``image.imdecode`` (PIL, and cv2 when PIL is absent), the one resize
against ``jax.image.resize``, every augmenter of ``image``, the detection
augmenters and both iterators, the vision transforms, and the random forms
of the image ops.

Inputs are seeded numpy arrays handed to both packages. Tolerances:
decoding, crops, flips, casts and nearest resizes are exact; a linear
resize is within 1e-4 on the [0, 255] scale in float32 and within one
level in uint8 (the two packages sum the same weights in another order,
and float-to-uint8 truncates); colour arithmetic within 1e-5 of
max(1, max|value|) (float32 sums in another order, and blends that
cancel to near zero). Host-side random draws: the port's
``random.seed(s)`` against Python's ``random.seed(s)`` and
``numpy.random.seed(s)`` on the reference side gives equal draws, so a
random augmenter's output is held to the reference's. The random image
ops draw on the device from the context's generator; each is checked by
outcome, its output against the reference's deterministic function at the
draw the port reports (``ops.image_ops.last_draw``).
"""
import io as _io
import random
import sys

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import image as jimage
from mxnet_tpu.gluon.data.vision import transforms as jtransforms
from mxnet_tpu.ops import image_ops as jops

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.gluon.data.vision import transforms as ttransforms
from mxnet_tpu_torch.ops import image_ops as tops

class Abs(float):
    """A tolerance that is absolute (not scaled by the values)."""


RESIZE_F32 = Abs(1e-4)
COLOUR = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def seed_both(s):
    random.seed(s)
    onp.random.seed(s)
    mt.random.seed(s)


def img(shape=(32, 40, 3), dtype="uint8", seed=0):
    rng = onp.random.RandomState(seed)
    if dtype == "uint8":
        return rng.randint(0, 256, shape).astype(onp.uint8)
    return (rng.rand(*shape) * 255).astype(dtype)


def pair(x):
    return mx.nd.array(x, dtype=x.dtype), mt.nd.array(x, ctx=mt.cpu(),
                                                      dtype=x.dtype)


def values(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else onp.asarray(a)


def assert_close(got, want, tol=0.0, levels=0):
    g, w = values(got), values(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert str(g.dtype) == str(w.dtype), (g.dtype, w.dtype)
    if g.dtype == onp.uint8:
        d = onp.abs(g.astype(onp.int32) - w.astype(onp.int32)).max() \
            if g.size else 0
        assert d <= levels, f"max |d| {d} levels (tol {levels})"
    elif tol == 0:
        onp.testing.assert_array_equal(g, w)
    else:
        scale = 1.0 if isinstance(tol, Abs) or not w.size else max(
            1.0, float(onp.abs(w.astype(onp.float64)).max()))
        onp.testing.assert_allclose(g, w, rtol=0, atol=tol * scale)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------
def _encoded(fmt):
    from PIL import Image
    bio = _io.BytesIO()
    Image.fromarray(img((20, 24, 3), seed=4)).save(bio, format=fmt,
                                                   quality=90)
    return bio.getvalue()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("flag,to_rgb", [(1, True), (1, False), (0, True)])
def test_imdecode_bitwise(fmt, flag, to_rgb):
    buf = _encoded(fmt)
    got = timage.imdecode(buf, flag, to_rgb)
    assert got.context == mt.cpu() and got.dtype == onp.uint8
    assert_close(got, jimage.imdecode(buf, flag, to_rgb))


def test_imdecode_through_cv2_without_pil(monkeypatch):
    pytest.importorskip("cv2")
    buf = _encoded("JPEG")
    monkeypatch.setitem(sys.modules, "PIL", None)
    for flag in (0, 1):
        assert_close(timage.imdecode(buf, flag), jimage.imdecode(buf, flag))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(MXNetError, match="imdecode requires PIL or cv2"):
        timage.imdecode(buf)


# ---------------------------------------------------------------------------
# the one resize
# ---------------------------------------------------------------------------
RESIZES = [((37, 29), (16, 20)), ((16, 20), (37, 29)), ((64, 48), (24, 60)),
           ((20, 12), (50, 45)), ((13, 7), (5, 40))]


@pytest.mark.parametrize("src,dst", RESIZES,
                         ids=[f"{a}to{b}" for a, b in RESIZES])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("interp", [0, 1])
def test_imresize_matches_jax_image_resize(src, dst, dtype, interp):
    x = img(src + (3,), dtype, seed=1)
    method = "nearest" if interp == 0 else "linear"
    want = onp.asarray(jax.image.resize(jnp.asarray(x, jnp.float32),
                                        dst + (3,), method)).astype(x.dtype)
    got = timage.imresize(mt.nd.array(x, dtype=dtype), dst[1], dst[0],
                          interp)
    assert_close(got, want, RESIZE_F32 if interp else 0.0,
                 levels=1 if interp else 0)
    assert_close(got, jimage.imresize(mx.nd.array(x, dtype=dtype), dst[1],
                                      dst[0], interp),
                 RESIZE_F32 if interp else 0.0, levels=1 if interp else 0)


def test_linear_resize_is_the_function_of_jax_weights():
    """At a large enlargement (60 -> 224 columns, 100 -> 224 rows) the
    port is within 1e-4 of the float64 product of ``jax.image``'s own
    weight matrices; ``jax.image.resize`` on the CPU is itself more than
    1e-4 from it (ROADMAP Queue 3), so the two packages agree there only
    within 1e-3."""
    from jax._src.image.scale import (ResizeMethod, _kernels,
                                      compute_weight_mat)
    x = img((100, 60, 3), "float32", seed=0)
    weight_mat = jax.jit(compute_weight_mat, static_argnums=(0, 1, 4, 5))
    weights = [onp.asarray(weight_mat(m, 224, 224 / m, 0.0,
                                      _kernels[ResizeMethod.LINEAR], True),
                           onp.float64)
               for m in (100, 60)]
    exact = onp.einsum("hwc,hH,wW->HWc", x.astype(onp.float64), *weights,
                       optimize=True)
    got = tops.resize(torch.from_numpy(x), (224, 224), (0, 1)).numpy()
    want = onp.asarray(jax.image.resize(jnp.asarray(x), (224, 224, 3),
                                        "linear"))
    assert onp.abs(got - exact).max() <= RESIZE_F32
    assert onp.abs(want - exact).max() > RESIZE_F32    # the reference's
    assert onp.abs(got - want).max() <= 1e-3
    for m, w in zip((100, 60), weights):
        onp.testing.assert_array_equal(
            tops._linear_weights(m, 224, "cpu").numpy(),
            w.astype(onp.float32))


# ---------------------------------------------------------------------------
# the augmenters
# ---------------------------------------------------------------------------
_MEAN = onp.array([123.68, 116.28, 103.53])
_STD = onp.array([58.395, 57.12, 57.375])


def _aug_cases(m):
    """(augmenter, input dtype, tol, levels) of image module ``m``."""
    return {
        "resize_short": (m.ResizeAug(24), "uint8", RESIZE_F32, 1),
        "resize_short_f32": (m.ResizeAug(50, interp=1), "float32",
                             RESIZE_F32, 0),
        "force_resize": (m.ForceResizeAug((30, 18)), "uint8", RESIZE_F32, 1),
        "force_resize_nearest": (m.ForceResizeAug((30, 18), 0), "uint8", 0, 0),
        "center_crop": (m.CenterCropAug((20, 16)), "uint8", 0, 0),
        "random_crop": (m.RandomCropAug((20, 16)), "uint8", 0, 0),
        "random_sized_crop": (m.RandomSizedCropAug((20, 20), (0.2, 1.0),
                                                   (0.75, 1.333)),
                              "uint8", RESIZE_F32, 1),
        "horizontal_flip": (m.HorizontalFlipAug(0.5), "uint8", 0, 0),
        "cast": (m.CastAug(), "uint8", 0, 0),
        "brightness": (m.BrightnessJitterAug(0.3), "float32", COLOUR, 0),
        "contrast": (m.ContrastJitterAug(0.3), "float32", COLOUR, 0),
        "saturation": (m.SaturationJitterAug(0.3), "float32", COLOUR, 0),
        "hue": (m.HueJitterAug(0.2), "float32", COLOUR, 0),
        "color_jitter": (m.ColorJitterAug(0.2, 0.2, 0.2), "float32", COLOUR,
                         0),
        "lighting": (m.LightingAug(0.1, m._PCA_EIGVAL, m._PCA_EIGVEC),
                     "float32", COLOUR, 0),
        "color_normalize": (m.ColorNormalizeAug(_MEAN, _STD), "float32",
                            COLOUR, 0),
        "random_gray": (m.RandomGrayAug(0.5), "float32", COLOUR, 0),
        "sequential": (m.SequentialAug([m.CenterCropAug((24, 24)),
                                        m.CastAug(),
                                        m.BrightnessJitterAug(0.2)]),
                       "uint8", COLOUR, 0),
        "random_order": (m.RandomOrderAug([m.BrightnessJitterAug(0.2),
                                           m.ContrastJitterAug(0.2),
                                           m.RandomGrayAug(0.5)]),
                         "float32", COLOUR, 0),
    }


@pytest.mark.parametrize("name", sorted(_aug_cases(timage)))
def test_augmenter_matches_the_jax_package(name):
    ref_aug, dtype, tol, levels = _aug_cases(jimage)[name]
    got_aug = _aug_cases(timage)[name][0]
    ref_in, got_in = pair(img(dtype=dtype, seed=2))
    for s in (0, 1, 2):          # several draws, both outcomes of a coin
        seed_both(s)
        want = ref_aug(ref_in)
        got = got_aug(got_in)
        assert got.context == mt.cpu()
        assert_close(got, want, tol, levels)


def test_create_augmenter_full_pipeline():
    kw = dict(resize=28, rand_resize=True, rand_mirror=True, brightness=0.2,
              contrast=0.2, saturation=0.2, hue=0.1, pca_noise=0.1,
              rand_gray=0.3, mean=True, std=True)
    ref_in, got_in = pair(img())
    for s in (0, 3):
        seed_both(s)
        want = ref_in
        for a in jimage.CreateAugmenter((3, 24, 24), **kw):
            want = a(want)
        got = got_in
        for a in timage.CreateAugmenter((3, 24, 24), **kw):
            got = a(got)
        assert got.shape == (24, 24, 3)
        # one level of a resized uint8 pixel is 1/58 after the std
        assert_close(got, want, 2e-2)


def _det_label():
    return onp.array([[0, 0.1, 0.2, 0.5, 0.6], [2, 0.4, 0.3, 0.9, 0.8],
                      [-1, 0, 0, 0, 0]], onp.float32)


def _det_cases(m):
    return {
        "borrow": (m.DetBorrowAug(m.CastAug()), 0.0),
        "flip": (m.DetHorizontalFlipAug(0.5), 0.0),
        "crop": (m.DetRandomCropAug(min_object_covered=0.1), 0.0),
        "pad": (m.DetRandomPadAug(), 0.0),
        "select": (m.DetRandomSelectAug([m.DetHorizontalFlipAug(1.0),
                                         m.DetRandomPadAug()], 0.3), 0.0),
        "create": (m.CreateDetAugmenter((3, 20, 20), rand_crop=0.5,
                                        rand_pad=0.5, rand_mirror=True,
                                        brightness=0.1, rand_gray=0.2,
                                        mean=True, std=True), 2e-2),
    }


@pytest.mark.parametrize("name", sorted(_det_cases(timage)))
def test_det_augmenter_matches_the_jax_package(name):
    ref_aug, tol = _det_cases(jimage)[name]
    got_aug = _det_cases(timage)[name][0]
    ref_in, got_in = pair(img(seed=5))
    for s in (0, 1, 2, 3):
        seed_both(s)
        want, got = (ref_in, _det_label()), (got_in, _det_label())
        for aug in (ref_aug if isinstance(ref_aug, list) else [ref_aug]):
            want = aug(*want)
        for aug in (got_aug if isinstance(got_aug, list) else [got_aug]):
            got = aug(*got)
        assert_close(got[0], want[0], tol)
        onp.testing.assert_array_equal(got[1], want[1])


def _write_rec(path, n=10, det=False):
    from PIL import Image
    w = trec.MXIndexedRecordIO(str(path.with_suffix(".idx")), str(path), "w")
    rng = onp.random.RandomState(7)
    for i in range(n):
        arr = rng.randint(0, 256, (30, 36, 3)).astype(onp.uint8)
        bio = _io.BytesIO()
        Image.fromarray(arr).save(bio, format="JPEG", quality=90)
        label = ([2, 5, 0, 0.1, 0.1, 0.6, 0.7, 1, 0.3, 0.2, 0.9, 0.9]
                 if det else float(i % 4))
        w.write_idx(i, trec.pack(trec.IRHeader(0, label, i, 0),
                                 bio.getvalue()))
    w.close()
    return str(path)


def test_image_iter_matches_the_jax_package(tmp_path):
    path = _write_rec(tmp_path / "c.rec")
    kw = dict(rand_crop=True, rand_mirror=True, mean=True, std=True)
    seed_both(4)
    ref = jimage.ImageIter(4, (3, 24, 24), path_imgrec=path, shuffle=True,
                           aug_list=jimage.CreateAugmenter((3, 24, 24), **kw))
    want = [next(ref) for _ in range(2)]
    seed_both(4)
    got_it = timage.ImageIter(4, (3, 24, 24), path_imgrec=path, shuffle=True,
                              aug_list=timage.CreateAugmenter((3, 24, 24),
                                                              **kw))
    got = [next(got_it) for _ in range(2)]
    for g, w in zip(got, want):
        assert g.data[0].context == mt.cpu()
        assert_close(g.data[0], w.data[0], COLOUR)
        assert_close(g.label[0], w.label[0])
    with pytest.raises(StopIteration):
        for _ in range(2):
            next(got_it)


def test_image_det_iter_matches_the_jax_package(tmp_path):
    path = _write_rec(tmp_path / "d.rec", det=True)
    seed_both(1)
    ref = jimage.ImageDetIter(
        3, (3, 20, 20), path_imgrec=path, label_pad=4,
        aug_list=jimage.CreateDetAugmenter((3, 20, 20), rand_mirror=True))
    want = next(ref)
    seed_both(1)
    got = next(timage.ImageDetIter(
        3, (3, 20, 20), path_imgrec=path, label_pad=4,
        aug_list=timage.CreateDetAugmenter((3, 20, 20), rand_mirror=True)))
    # the uint8 resize's one level, in the float32 batch
    assert_close(got.data[0], want.data[0], Abs(1.0))
    assert_close(got.label[0], want.label[0])
    with pytest.raises(MXNetError, match="label_pad"):
        next(timage.ImageDetIter(3, (3, 20, 20), path_imgrec=path,
                                 label_pad=1))


# ---------------------------------------------------------------------------
# the vision transforms
# ---------------------------------------------------------------------------
def _transform_cases(t):
    return {
        "to_tensor": (t.ToTensor(), "uint8", 0.0),
        "normalize": (t.Normalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.4)),
                      "chw", 0.0),
        "cast": (t.Cast("float16"), "uint8", 0.0),
        "resize": (t.Resize((20, 24)), "uint8", RESIZE_F32),
        "resize_keep_ratio": (t.Resize(20, keep_ratio=True), "float32",
                              RESIZE_F32),
        "center_crop": (t.CenterCrop(24), "uint8", 0.0),
        "center_crop_up": (t.CenterCrop((36, 50)), "uint8", RESIZE_F32),
        "random_resized_crop": (t.RandomResizedCrop(24), "uint8", RESIZE_F32),
        "flip_lr": (t.RandomFlipLeftRight(), "uint8", 0.0),
        "flip_tb": (t.RandomFlipTopBottom(), "uint8", 0.0),
        "brightness": (t.RandomBrightness(0.3), "uint8", COLOUR),
        "contrast": (t.RandomContrast(0.3), "uint8", COLOUR),
        "saturation": (t.RandomSaturation(0.3), "uint8", COLOUR),
        "hue": (t.RandomHue(0.2), "float32", COLOUR),
        "color_jitter": (t.RandomColorJitter(0.2, 0.2, 0.2, 0.1), "float32",
                         COLOUR),
        "lighting": (t.RandomLighting(0.1), "float32", COLOUR),
        "rotate": (t.Rotate(30), "float32", COLOUR),
        "rotate_zoom_in": (t.Rotate(-20, zoom_in=True), "float32", COLOUR),
        "rotate_zoom_out": (t.Rotate(45, zoom_out=True), "float32", COLOUR),
        "random_rotation": (t.RandomRotation((-30, 30),
                                             rotate_with_proba=0.5),
                            "float32", COLOUR),
        "crop_resize": (t.CropResize(4, 2, 20, 16, size=(12, 10)), "uint8",
                        RESIZE_F32),
        "random_apply": (t.RandomApply(t.RandomBrightness(0.5), 0.5),
                         "float32", COLOUR),
        "compose": (t.Compose([t.RandomResizedCrop(24),
                               t.RandomFlipLeftRight(), t.ToTensor(),
                               t.Normalize((0.485, 0.456, 0.406),
                                           (0.229, 0.224, 0.225))]),
                    "uint8", RESIZE_F32),
    }


@pytest.mark.parametrize("name", sorted(_transform_cases(ttransforms)))
def test_transform_matches_the_jax_package(name):
    ref_t, kind, tol = _transform_cases(jtransforms)[name]
    got_t = _transform_cases(ttransforms)[name][0]
    x = img(dtype="float32" if kind == "chw" else kind, seed=6)
    if kind == "chw":
        x = (x / 255.0).transpose(2, 0, 1).copy()
    for s in (0, 1, 2):
        seed_both(s)
        want = ref_t(mx.nd.array(x, dtype=x.dtype))
        got = got_t(x)                # numpy in: the port's run on cpu()
        assert got.context == mt.cpu()
        assert_close(got, want, tol, levels=1)


# ---------------------------------------------------------------------------
# the random image ops, by outcome
# ---------------------------------------------------------------------------
def _jax(fn, x, *args):
    return onp.asarray(fn(jnp.asarray(x), *args))


def _random_op_cases():
    flip_lr = lambda x, d: onp.asarray(  # noqa: E731
        jops.flip_left_right(jnp.asarray(x)) if d["u"] < 0.5 else x)
    flip_tb = lambda x, d: onp.asarray(  # noqa: E731
        jops.flip_top_bottom(jnp.asarray(x)) if d["u"] < 0.5 else x)

    def colour(fn):
        return lambda x, d: _jax(fn, x, float(d["alpha"]))

    def jitter(x, d):
        out = jnp.asarray(x, jnp.float32)
        for name, fn in (("brightness", jops._adjust_brightness),
                         ("contrast", jops._adjust_contrast),
                         ("saturation", jops._adjust_saturation),
                         ("hue", jops._adjust_hue)):
            if name in d:
                out = fn(out, float(d[name]))
        return onp.asarray(out)

    def lighting(x, d):
        return onp.asarray(jops.adjust_lighting(
            jnp.asarray(x), alpha=tuple(float(a) for a in d["alpha"])))

    nd = mt.nd.image
    return {
        "flip_left_right": (nd.random_flip_left_right, flip_lr, 0.0),
        "flip_top_bottom": (nd.random_flip_top_bottom, flip_tb, 0.0),
        "brightness": (lambda x: nd.random_brightness(x, 0.5, 1.5),
                       colour(jops._adjust_brightness), COLOUR),
        "contrast": (lambda x: nd.random_contrast(x, 0.5, 1.5),
                     colour(jops._adjust_contrast), COLOUR),
        "saturation": (lambda x: nd.random_saturation(x, 0.5, 1.5),
                       colour(jops._adjust_saturation), COLOUR),
        "hue": (lambda x: nd.random_hue(x, -0.3, 0.3),
                colour(jops._adjust_hue), COLOUR),
        "color_jitter": (lambda x: nd.random_color_jitter(x, 0.3, 0.3, 0.3,
                                                          0.2),
                         jitter, COLOUR),
        "color_jitter_some": (lambda x: nd.random_color_jitter(
            x, brightness=0.3, hue=0.2), jitter, COLOUR),
        "lighting": (lambda x: nd.random_lighting(x, 0.3), lighting, COLOUR),
    }


@pytest.mark.parametrize("name", sorted(_random_op_cases()))
@pytest.mark.parametrize("batched", [False, True], ids=["hwc", "nhwc"])
def test_random_image_op_is_its_function_at_the_draw(name, batched):
    op, ref_fn, tol = _random_op_cases()[name]
    x = img((2, 8, 10, 3) if batched else (8, 10, 3), "float32", seed=3)
    mt.random.seed(11)
    outcomes = set()
    for _ in range(8):
        got = op(mt.nd.array(x))
        draw = tops.last_draw()
        assert draw, "the op reported no draw"
        assert_close(got, ref_fn(x, draw).astype(onp.float32), tol)
        if "u" in draw:
            outcomes.add(bool(draw["u"] < 0.5))
    if name.startswith("flip"):
        assert outcomes == {True, False}


def test_random_image_ops_are_seeded_by_random_seed():
    x = mt.nd.array(img((6, 6, 3), "float32"))
    mt.random.seed(5)
    a = mt.nd.image.random_color_jitter(x, 0.3, 0.3, 0.3, 0.2).asnumpy()
    mt.random.seed(5)
    b = mt.nd.image.random_color_jitter(x, 0.3, 0.3, 0.3, 0.2).asnumpy()
    onp.testing.assert_array_equal(a, b)
