"""The port's sparse storage (``mxnet_tpu_torch.sparse``), row-sparse
gradients and lazy updates against the JAX package on the CPU: the cases
of the reference's ``tests/test_sparse.py`` but its kvstore ones (the
multi-GPU slice) and ``test_libsvm_iter`` (the data slice).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: storage conversions, gathers and scatters without duplicates
are exact; sums of duplicate rows are exact against the port's own dense
path on the CPU (both add each row's parts in their order from zero, the
reference's test asks the same of its own pair) and within 1e-6 of the
reference's; products (``dot``) within 1e-5 relative (sum order); the lazy
optimizer updates within rtol 1e-5, atol 1e-7, as the dense ones in
``test_torch_optimizer.py``; the sparse-embedding LM's losses within the
reference test's own rtol of 0.08 of its dense twin.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import sparse as jsparse

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, autograd, nd, sparse
from mxnet_tpu_torch.sparse import CSRNDArray, RowSparseNDArray

torch.set_num_threads(2)
# Some PyTorch CPU builds compute the first task an intra-op pool thread
# runs at reduced precision; one parallel op primes the pool first.
torch.exp(torch.zeros(1 << 18))


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


@pytest.fixture
def amp_off(monkeypatch):
    """AMP is global state in both packages: after the test it is off in
    both, and the reference's registry has the ``invoke`` its
    ``amp.init`` replaced (the other files of the xdist worker run in the
    same process)."""
    import mxnet_tpu.ndarray as jnd
    from mxnet_tpu.ops import registry as jreg
    monkeypatch.setattr(jreg, "invoke", jreg.invoke)
    for name, default in (("_amp_wrapped", False), ("_amp_config", None)):
        monkeypatch.setattr(jreg, name, getattr(jreg, name, default),
                            raising=False)
    monkeypatch.setattr(jnd, "_apply_op", jnd._apply_op)
    yield
    mt.amp._AMP_STATE["on"] = False
    mx.amp._AMP_STATE["on"] = False


def _rand_dense(shape, density=0.3, seed=0):
    rng = onp.random.RandomState(seed)
    return rng.randn(*shape).astype("float32") * (rng.rand(*shape) < density)


def _same(port, ref, exact=True):
    a, b = port.asnumpy(), onp.asarray(ref.asnumpy(), onp.float32)
    if exact:
        onp.testing.assert_array_equal(a, b)
    else:
        onp.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# storage
# ---------------------------------------------------------------------------
def test_row_sparse_roundtrip():
    dense = onp.zeros((6, 4), "float32")
    dense[1], dense[4] = 1.5, -2.0
    rsp = nd.array(dense).tostype("row_sparse")
    ref = mx.nd.array(dense).tostype("row_sparse")
    assert isinstance(rsp, RowSparseNDArray) and rsp.stype == "row_sparse"
    assert rsp.nnz == ref.nnz == 2
    assert rsp.indices.asnumpy().tolist() == ref.indices.asnumpy().tolist() \
        == [1, 4]
    _same(rsp, ref)
    back = rsp.tostype("default")
    assert back.stype == "default"
    onp.testing.assert_array_equal(back.asnumpy(), dense)


def test_csr_roundtrip():
    dense = _rand_dense((5, 7))
    csr, ref = nd.array(dense).tostype("csr"), \
        mx.nd.array(dense).tostype("csr")
    assert isinstance(csr, CSRNDArray) and csr.stype == "csr"
    for attr in ("data", "indices", "indptr"):
        onp.testing.assert_array_equal(getattr(csr, attr).asnumpy(),
                                       getattr(ref, attr).asnumpy())
    assert csr.indptr.asnumpy()[-1] == csr.nnz
    _same(csr.todense(), ref.todense())
    _same(csr.tostype("row_sparse"), ref.tostype("row_sparse"))


def test_constructors():
    rows = onp.ones((2, 3), "float32")
    rsp = sparse.row_sparse_array((rows, [1, 3]), shape=(5, 3))
    _same(rsp, jsparse.row_sparse_array((rows, [1, 3]), shape=(5, 3)))
    assert rsp.shape == (5, 3)
    args = (onp.array([1., 2., 3.], "float32"), [0, 2, 1], [0, 2, 2, 3])
    _same(sparse.csr_matrix(args, shape=(3, 4)),
          jsparse.csr_matrix(args, shape=(3, 4)))
    import scipy.sparse as sp
    m = sp.random(4, 6, density=0.4, random_state=3, dtype=onp.float32)
    _same(sparse.csr_matrix(m), jsparse.csr_matrix(m))
    z = sparse.zeros("row_sparse", (4, 2))
    assert z.nnz == 0 and z.stype == "row_sparse"
    onp.testing.assert_array_equal(z.asnumpy(), onp.zeros((4, 2)))
    assert isinstance(sparse.array(m), CSRNDArray)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_save_load_sparse_across_packages(writer, tmp_path):
    """A file of row-sparse, CSR and dense records written by either
    package loads in the other with the same storage and values, and the
    two packages write the same bytes."""
    dense = _rand_dense((6, 3))
    csr_dense = _rand_dense((4, 5), seed=1)
    f_port, f_ref = str(tmp_path / "port.params"), str(tmp_path / "ref.params")
    nd.save(f_port, {"rsp": nd.array(dense).tostype("row_sparse"),
                     "csr": nd.array(csr_dense).tostype("csr"),
                     "dense": nd.array(dense)})
    mx.nd.save(f_ref, {"rsp": mx.nd.array(dense).tostype("row_sparse"),
                       "csr": mx.nd.array(csr_dense).tostype("csr"),
                       "dense": mx.nd.array(dense)})
    with open(f_port, "rb") as a, open(f_ref, "rb") as b:
        assert a.read() == b.read()
    path = f_port if writer == "port" else f_ref
    for loaded, kinds in ((nd.load(path), (RowSparseNDArray, CSRNDArray)),
                          (mx.nd.load(path), (jsparse.RowSparseNDArray,
                                              jsparse.CSRNDArray))):
        assert isinstance(loaded["rsp"], kinds[0])
        assert isinstance(loaded["csr"], kinds[1])
        onp.testing.assert_array_equal(loaded["rsp"].asnumpy(), dense)
        onp.testing.assert_array_equal(loaded["csr"].asnumpy(), csr_dense)
        onp.testing.assert_array_equal(loaded["dense"].asnumpy(), dense)


def test_load_drops_the_reference_padding_rows(tmp_path):
    """A row-sparse array the reference holds with static-nnz padding
    (ids = rows, after ``retain``) is written without it, and reads back
    with the kept rows only."""
    ref = jsparse.row_sparse_array((onp.array([[1., 1], [2, 2], [3, 3]]),
                                    [1, 4, 7]), shape=(10, 2)).retain(
        mx.nd.array([4, 9]))
    path = str(tmp_path / "padded.params")
    mx.nd.save(path, {"r": ref})
    got = nd.load(path)["r"]
    assert got.nnz == 1 and got.indices.asnumpy().tolist() == [4]
    _same(got, ref.todense())


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------
def test_csr_dot():
    lhs = _rand_dense((5, 7), seed=2)
    rhs = onp.random.RandomState(3).randn(7, 4).astype("float32")
    rhs_t = onp.random.RandomState(4).randn(5, 4).astype("float32")
    csr, jcsr = nd.array(lhs).tostype("csr"), mx.nd.array(lhs).tostype("csr")
    _same(sparse.dot(csr, nd.array(rhs)), jsparse.dot(jcsr, mx.nd.array(rhs)),
          exact=False)
    _same(sparse.dot(csr, nd.array(rhs_t), transpose_a=True),
          jsparse.dot(jcsr, mx.nd.array(rhs_t), transpose_a=True),
          exact=False)
    _same(nd.dot(csr, nd.array(rhs)), mx.nd.dot(jcsr, mx.nd.array(rhs)),
          exact=False)


def test_rsp_dot_and_scalar_ops():
    lhs = onp.zeros((6, 3), "float32")
    lhs[2], lhs[5] = [1, 2, 3], [-1, 0, 1]
    rhs = onp.random.RandomState(5).randn(3, 2).astype("float32")
    rsp, jrsp = nd.array(lhs).tostype("row_sparse"), \
        mx.nd.array(lhs).tostype("row_sparse")
    _same(sparse.dot(rsp, nd.array(rhs)), jsparse.dot(jrsp, mx.nd.array(rhs)),
          exact=False)
    scaled = rsp * 2.0
    assert isinstance(scaled, RowSparseNDArray)
    _same(scaled, jrsp * 2.0)
    s = rsp + rsp
    assert isinstance(s, RowSparseNDArray)
    _same(s, jrsp + jrsp)


def test_retain():
    """The kept rows equal the reference's; the port keeps exactly them,
    where the reference pads to the input's nnz with id = rows (a static
    shape for XLA)."""
    dense = onp.diag(onp.arange(1, 5, dtype="float32"))
    _same(sparse.retain(nd.array(dense).tostype("row_sparse"), [0, 2]),
          jsparse.retain(mx.nd.array(dense).tostype("row_sparse"), [0, 2]))
    rows = onp.array([[1., 1], [2, 2], [3, 3]], "float32")
    out = sparse.row_sparse_array((rows, [1, 4, 7]), shape=(10, 2)).retain(
        nd.array([4, 9]))
    ref = jsparse.row_sparse_array((rows, [1, 4, 7]), shape=(10, 2)).retain(
        mx.nd.array([4, 9]))
    _same(out.todense(), ref.todense())
    assert out.nnz == 1 and ref.nnz == 3
    assert out.indices.asnumpy().tolist() == [4]


def test_add_n_dedup():
    a = (onp.ones((2, 2), "float32"), [0, 2])
    b = (onp.full((2, 2), 2.0, "float32"), [2, 3])
    s = sparse.add_n([sparse.row_sparse_array(a, shape=(4, 2)),
                      sparse.row_sparse_array(b, shape=(4, 2))])
    ref = jsparse.add_n([jsparse.row_sparse_array(a, shape=(4, 2)),
                         jsparse.row_sparse_array(b, shape=(4, 2))])
    assert isinstance(s, RowSparseNDArray)
    assert s.indices.asnumpy().tolist() == [0, 2, 3]   # sorted, unique
    _same(s, ref)


def test_csr_elemwise_same_pattern():
    d = onp.array([[0, 1., 0], [2., 0, 3.]], "float32")
    a, b = sparse.csr_matrix(d), sparse.csr_matrix(2 * d)
    ja, jb = jsparse.csr_matrix(d), jsparse.csr_matrix(2 * d)
    for got, want in ((sparse.elemwise_add(a, b), jsparse.elemwise_add(ja, jb)),
                      (sparse.elemwise_mul(a, b), jsparse.elemwise_mul(ja, jb)),
                      (a * 4.0, ja * 4.0)):
        assert got.stype == "csr"
        _same(got.todense(), want.todense())


def test_csr_elemwise_different_pattern_densifies_correctly():
    d1 = onp.array([[0, 1., 0], [2., 0, 0]], "float32")
    d2 = onp.array([[5., 0, 0], [0, 0, 7.]], "float32")
    a, b = sparse.csr_matrix(d1), sparse.csr_matrix(d2)
    ja, jb = jsparse.csr_matrix(d1), jsparse.csr_matrix(d2)
    _same((a + b).todense(), (ja + jb).todense())
    _same((a * b).todense(), (ja * jb).todense())


def test_csr_csr_dot():
    rng = onp.random.RandomState(0)
    d1 = (rng.rand(4, 6) * (rng.rand(4, 6) > 0.5)).astype("float32")
    d2 = (rng.rand(6, 3) * (rng.rand(6, 3) > 0.5)).astype("float32")
    _same(sparse.dot(sparse.csr_matrix(d1), sparse.csr_matrix(d2)),
          jsparse.dot(jsparse.csr_matrix(d1), jsparse.csr_matrix(d2)),
          exact=False)


def test_sparse_astype():
    args = (onp.array([[1., 2]], "float32"), [3])
    out = sparse.row_sparse_array(args, shape=(5, 2)).astype("bfloat16")
    ref = jsparse.row_sparse_array(args, shape=(5, 2)).astype("bfloat16")
    assert out.dtype == str(ref.dtype) == "bfloat16"
    _same(out.todense(), ref.todense())


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_square_sum(axis):
    dense = _rand_dense((6, 4), density=0.5, seed=7)
    _same(nd._square_sum(nd.array(dense).tostype("row_sparse"), axis=axis),
          mx.nd._square_sum(mx.nd.array(dense).tostype("row_sparse"),
                            axis=axis), exact=False)


def test_cast_storage_names():
    dense = _rand_dense((3, 4), seed=8)
    assert nd.cast_storage(nd.array(dense), "csr").stype == "csr"
    assert isinstance(nd.sparse.zeros("row_sparse", (2, 2)), RowSparseNDArray)


# ---------------------------------------------------------------------------
# autograd: the Embedding's row-sparse gradient
# ---------------------------------------------------------------------------
def _embedding_grads(pkg, w_np, tokens, sparse_grad):
    w = pkg.nd.array(w_np)
    w.attach_grad(stype="row_sparse" if sparse_grad else None)
    with pkg.autograd.record():
        emb = pkg.nd.Embedding(pkg.nd.array(tokens, dtype="int32"), w,
                               input_dim=w_np.shape[0],
                               output_dim=w_np.shape[1],
                               sparse_grad=sparse_grad)
        loss = (emb * emb).sum()
    loss.backward()
    return w.grad


def test_embedding_sparse_grad_matches_dense():
    w_np = onp.random.RandomState(0).randn(10, 4).astype("float32")
    tokens = onp.array([[1, 3], [3, 7]])
    sp = _embedding_grads(mt, w_np, tokens, True)
    dense = _embedding_grads(mt, w_np, tokens, False)
    ref = _embedding_grads(mx, w_np, tokens, True)
    assert isinstance(sp, RowSparseNDArray)
    assert sp.indices.asnumpy().tolist() == [1, 3, 7]   # row 3 hit twice
    onp.testing.assert_array_equal(sp.asnumpy(), dense.asnumpy())
    onp.testing.assert_allclose(sp.asnumpy(), ref.asnumpy(), rtol=1e-6,
                                atol=1e-6)


def test_gluon_embedding_sparse_grad_end_to_end():
    from mxnet_tpu_torch.gluon import nn
    net = nn.Embedding(20, 6, sparse_grad=True)
    net.initialize()
    assert net.weight._grad_stype == "row_sparse"
    x = nd.array(onp.array([[0, 5, 5, 19]]), dtype="int32")
    with autograd.record():
        loss = net(x).sum()
    loss.backward()
    g = net.weight.grad()
    assert isinstance(g, RowSparseNDArray)
    assert g.indices.asnumpy().tolist() == [0, 5, 19]
    gd = g.asnumpy()
    assert gd[5].sum() == 12.0 and not gd[1].any()


def test_gluon_embedding_sparse_vs_dense_grad_bitwise():
    """The sparse gradient densifies bitwise equal to the dense one on the
    CPU (each row adds its hits in their order from zero in both), and
    within 1e-6 of the reference's."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn
    rng = onp.random.RandomState(3)
    w0 = rng.randn(12, 5).astype("float32")
    tokens = onp.array([[3, 7, 3], [7, 0, 3]])
    scale = rng.randn(2, 3, 5).astype("float32")
    grads = {}
    for pkg, layers in ((mt, nn), (mx, jnn)):
        for sg in (False, True):
            net = layers.Embedding(12, 5, sparse_grad=sg)
            net.initialize()
            net.weight.set_data(pkg.nd.array(w0))
            with pkg.autograd.record():
                loss = (net(pkg.nd.array(tokens, dtype="int32"))
                        * pkg.nd.array(scale)).sum()
            loss.backward()
            grads[pkg.__name__, sg] = net.weight.grad()
    assert isinstance(grads["mxnet_tpu_torch", True], RowSparseNDArray)
    got = grads["mxnet_tpu_torch", True].asnumpy()
    assert onp.array_equal(got, grads["mxnet_tpu_torch", False].asnumpy())
    onp.testing.assert_allclose(got, grads["mxnet_tpu", True].asnumpy(),
                                rtol=1e-6, atol=1e-6)


def test_autograd_grad_returns_row_sparse():
    from mxnet_tpu_torch.gluon import nn
    embed = nn.Embedding(10, 4, sparse_grad=True)
    embed.initialize()
    x = nd.array(onp.array([1, 3, 3, 7]), dtype="int32")
    w = embed.weight.data()
    with autograd.record():
        loss = embed(x).sum()
    g = autograd.grad(loss, [w])[0]
    assert isinstance(g, RowSparseNDArray)
    exp = onp.zeros((10, 4), "float32")
    for i in [1, 3, 3, 7]:
        exp[i] += 1
    onp.testing.assert_array_equal(g.asnumpy(), exp)


def test_sparse_grad_add_req_nnz_capped():
    """grad_req='add' over four backwards: nnz stays the distinct rows
    touched, the values add up."""
    from mxnet_tpu_torch.gluon import nn
    embed = nn.Embedding(10, 4, sparse_grad=True)
    embed.initialize()
    embed.weight.grad_req = "add"
    x = nd.array(onp.array([1, 3, 3, 7]), dtype="int32")
    for _ in range(4):
        with autograd.record():
            loss = embed(x).sum()
        loss.backward()
    g = embed.weight.grad()
    assert isinstance(g, RowSparseNDArray) and g.nnz == 3
    exp = onp.zeros((10, 4), "float32")
    for i in [1, 3, 3, 7]:
        exp[i] += 4.0
    onp.testing.assert_array_equal(g.asnumpy(), exp)


def test_contrib_sparse_embedding_gives_a_row_sparse_gradient():
    w = nd.array(onp.random.RandomState(4).randn(6, 3).astype("float32"))
    w.attach_grad(stype="row_sparse")
    with autograd.record():
        loss = nd._contrib_SparseEmbedding(
            nd.array([2, 2, 5], dtype="int32"), w, input_dim=6,
            output_dim=3).sum()
    loss.backward()
    assert w.grad.indices.asnumpy().tolist() == [2, 5]
    assert w.grad.asnumpy()[2].tolist() == [2.0, 2.0, 2.0]


def test_embedding_under_amp_keeps_the_sparse_gradient(amp_off):
    """Under amp.init the Embedding's weight is cast to the target dtype
    (a TARGET op); the port's cast keeps the row-sparse gradient, in the
    weight's f32, within one bf16 rounding of the f32 gradient. The
    reference's cast builds an untaped array, so its weight gets no
    gradient at all (ROADMAP Queue 3)."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn
    w0 = onp.random.RandomState(5).randn(8, 4).astype("float32")
    tokens = onp.array([[1, 6, 1]])
    grads = {}
    for pkg, layers in ((mt, nn), (mx, jnn)):
        pkg.amp.init("bfloat16")
        net = layers.Embedding(8, 4, sparse_grad=True)
        net.initialize()
        net.weight.set_data(pkg.nd.array(w0))
        with pkg.autograd.record():
            out = net(pkg.nd.array(tokens, dtype="int32"))
            loss = (out.astype("float32") * 3.0).sum()
        loss.backward()
        assert str(out.dtype) == "bfloat16"
        grads[pkg.__name__] = net.weight.grad()
    got = grads["mxnet_tpu_torch"]
    assert isinstance(got, RowSparseNDArray) and got.dtype == "float32"
    assert got.indices.asnumpy().tolist() == [1, 6]
    want = onp.zeros((8, 4), "float32")
    want[1], want[6] = 6.0, 3.0
    onp.testing.assert_array_equal(got.asnumpy(), want)
    assert not grads["mxnet_tpu"].asnumpy().any()


def test_clip_global_norm_on_a_row_sparse_gradient():
    """The port takes a row-sparse array's stored rows (unique, so its
    dense norm) into the global norm and scales them; the reference's
    function raises TypeError on one (ROADMAP Queue 3)."""
    from mxnet_tpu.gluon.utils import clip_global_norm as jclip
    from mxnet_tpu_torch.gluon.utils import clip_global_norm
    rows = onp.array([[3., 4.], [1., 1.]], "float32")
    r = sparse.row_sparse_array((rows, [1, 3]), shape=(5, 2))
    d = nd.array(onp.array([[12., 0.]], "float32"))
    norm = clip_global_norm([r, d], 1.0)
    assert norm == pytest.approx(onp.sqrt(9 + 16 + 1 + 1 + 144), rel=1e-6)
    assert isinstance(r, RowSparseNDArray)
    onp.testing.assert_allclose(r.data.asnumpy(), rows / (norm + 1e-8),
                                rtol=1e-6)
    with pytest.raises(TypeError):
        jclip([jsparse.row_sparse_array((rows, [1, 3]), shape=(5, 2)),
               mx.nd.array(onp.array([[12., 0.]], "float32"))], 1.0)


# ---------------------------------------------------------------------------
# the lazy updates
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt_name, kwargs", [
    ("SGD", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("Adam", {"learning_rate": 0.01, "wd": 0.01}),
    ("AdaGrad", {"learning_rate": 0.1}),
])
def test_sparse_optimizer_lazy_update(opt_name, kwargs):
    """Two lazy updates of the touched rows (ids out of order, one twice)
    equal the reference's, and leave the other rows and their state as
    they were."""
    vocab, dim = 8, 3
    rng = onp.random.RandomState(1)
    w_np = rng.randn(vocab, dim).astype("float32")
    g_rows = rng.randn(3, dim).astype("float32")
    touched = [5, 2, 5]
    out = {}
    for pkg, sp in ((mt, sparse), (mx, jsparse)):
        opt = getattr(pkg.optimizer, opt_name)(**kwargs)
        w = pkg.nd.array(w_np)
        state = opt.create_state_multi_precision(0, w)
        for _ in range(2):
            opt.update(0, w, sp.row_sparse_array((g_rows, touched),
                                                 shape=(vocab, dim)), state)
        out[pkg.__name__] = w.asnumpy()
    onp.testing.assert_allclose(out["mxnet_tpu_torch"], out["mxnet_tpu"],
                                rtol=1e-5, atol=1e-7)
    untouched = [i for i in range(vocab) if i not in touched]
    onp.testing.assert_array_equal(out["mxnet_tpu_torch"][untouched],
                                   w_np[untouched])


def test_sparse_optimizer_duplicate_indices_summed():
    opt = mt.optimizer.SGD(learning_rate=1.0)
    w = nd.array(onp.zeros((4, 2), "float32"))
    grad = sparse.row_sparse_array((onp.ones((2, 2), "float32"), [1, 1]),
                                   shape=(4, 2))
    opt.update(0, w, grad, None)
    onp.testing.assert_array_equal(w.asnumpy()[1], [-2.0, -2.0])


def test_lazy_update_of_a_half_weight_uses_its_master():
    """multi_precision with a bf16 weight: the touched rows of the f32
    master are updated and rounded into the weight, as the reference
    does."""
    w_np = onp.random.RandomState(6).randn(6, 2).astype("float32")
    g = (onp.random.RandomState(7).randn(2, 2).astype("float32"), [0, 4])
    out = {}
    for pkg, sp in ((mt, sparse), (mx, jsparse)):
        opt = pkg.optimizer.Adam(learning_rate=0.01, multi_precision=True)
        w = pkg.nd.array(w_np).astype("bfloat16")
        state = opt.create_state_multi_precision(0, w)
        opt.update_multi_precision(0, w, sp.row_sparse_array(g, shape=(6, 2)),
                                   state)
        out[pkg.__name__] = (w.asnumpy(), state[0].asnumpy()
                             if hasattr(state[0], "asnumpy")
                             else state[0].float().numpy())
    onp.testing.assert_allclose(out["mxnet_tpu_torch"][1],
                                out["mxnet_tpu"][1], rtol=1e-5, atol=1e-7)
    onp.testing.assert_array_equal(out["mxnet_tpu_torch"][0],
                                   out["mxnet_tpu"][0])


# ---------------------------------------------------------------------------
# the Trainer: a sparse-embedding LM against its dense twin
# ---------------------------------------------------------------------------
def _copy_params(src, dst):
    """By structural name (the global name counters move between the
    twins)."""
    want = dst._collect_params_with_prefix()
    for k, a in src._collect_params_with_prefix().items():
        want[k].set_data(a.data())


def _lm(layers, rnn, gluon, vocab, emb, hid, sparse_grad):
    class LM(gluon.Block):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.embed = layers.Embedding(vocab, emb,
                                              sparse_grad=sparse_grad)
                self.lstm = rnn.LSTM(hid, num_layers=1, layout="NTC",
                                     input_size=emb)
                self.decoder = layers.Dense(vocab, flatten=False,
                                            in_units=hid)

        def forward(self, x):
            return self.decoder(self.lstm(self.embed(x)))
    return LM()


def test_lstm_lm_sparse_embedding_trains():
    """Lazy Adam on the row-sparse embedding gradient: the trainer carries
    ``_contains_sparse_grad``, the gradient is a RowSparseNDArray, the loss
    falls, and the losses track the dense-embedding twin from the same
    weights within the reference test's rtol of 0.08."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn, rnn
    vocab, emb, hid, seq, batch = 50, 16, 32, 8, 4
    rng = onp.random.RandomState(0)
    data = rng.randint(0, vocab, (batch, seq + 1))
    x = nd.array(data[:, :-1], dtype="int32")
    y = nd.array(data[:, 1:].astype("float32"))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    nets = {sg: _lm(nn, rnn, gluon, vocab, emb, hid, sg)
            for sg in (True, False)}
    nets[True].initialize(mt.init.Xavier())
    nets[False].initialize(mt.init.Xavier())
    _copy_params(nets[True], nets[False])
    losses = {}
    for sg, net in nets.items():
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.01})
        assert trainer._contains_sparse_grad is sg
        losses[sg] = []
        for _ in range(12):
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(batch)
            losses[sg].append(float(loss.mean().asscalar()))
    assert isinstance(nets[True].embed.weight.grad(), RowSparseNDArray)
    assert losses[True][-1] < losses[True][0] * 0.85, losses[True]
    onp.testing.assert_allclose(losses[True], losses[False], rtol=0.08)


def test_lazy_sgd_equals_the_dense_update():
    """SGD without momentum, wd or clipping: the lazy update is the dense
    update (an untouched row's gradient is zero), so five steps of the
    sparse and the dense twin give the same weights (the sums agree
    bitwise on the CPU)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn, rnn
    vocab, emb, hid, seq, batch = 40, 8, 16, 6, 3
    rng = onp.random.RandomState(1)
    data = rng.randint(0, vocab, (batch, seq + 1))
    x = nd.array(data[:, :-1], dtype="int32")
    y = nd.array(data[:, 1:].astype("float32"))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    nets = {sg: _lm(nn, rnn, gluon, vocab, emb, hid, sg)
            for sg in (True, False)}
    for net in nets.values():
        net.initialize(mt.init.Xavier())
    _copy_params(nets[True], nets[False])
    for net in nets.values():
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.5})
        for _ in range(5):
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(batch)
    dense = nets[False]._collect_params_with_prefix()
    for k, a in nets[True]._collect_params_with_prefix().items():
        onp.testing.assert_array_equal(a.data().asnumpy(),
                                       dense[k].data().asnumpy(), err_msg=k)


def test_parameter_refuses_sparse_weight_storage():
    from mxnet_tpu_torch.gluon.parameter import Parameter
    with pytest.raises(MXNetError, match="sparse weight storage"):
        Parameter("w", shape=(2, 2), stype="row_sparse")
