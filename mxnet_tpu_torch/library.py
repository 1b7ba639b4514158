"""Library initialization and external op libraries of the port (the
counterpart of ``mxnet_tpu/library.py``).

- Fork safety: the native host engine (``engine.py``, ``native/engine.cc``)
  owns a pool of worker threads that a fork does not copy.
  ``os.register_at_fork`` drains it in the parent before a fork and, in
  the child, drops the parent's engine so that the child's first
  ``get_engine()`` builds a fresh one (the reference's atfork_prepare /
  atfork_child discipline).
- Crash logging: ``faulthandler`` prints every thread's Python stack on
  SIGSEGV, SIGFPE, SIGABRT and SIGBUS, unless
  ``MXNET_USE_SIGNAL_HANDLER=0``.
- ``load(path)``: a user's library of C ops, loaded with ctypes, each op
  registered as a ``Custom`` op (``nd.Custom(*data, op_type=name)``). Its
  data crosses to the host as float32 numpy arrays and back, as in the
  reference.
"""
from __future__ import annotations

import os
import sys

from .base import MXNetError

__all__ = ["load", "initialize"]

_INITIALIZED = False


def _atfork_prepare():
    from . import engine
    if engine._engine is not None:
        try:
            engine._engine.wait_all()
        except Exception:  # noqa: BLE001 — a task's error never blocks a fork
            pass


def _atfork_child():
    from . import engine
    with engine._lock:
        eng = engine._engine
        engine._engine = None
    if eng is not None and hasattr(eng, "_h"):
        eng._h = None   # the pool's memory is the parent's: never destroyed


def initialize():
    """Install the fork handlers and the crash logger (once)."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    _INITIALIZED = True
    os.register_at_fork(before=_atfork_prepare, after_in_child=_atfork_child)
    from . import config
    if config.get("MXNET_USE_SIGNAL_HANDLER"):
        import faulthandler
        if not faulthandler.is_enabled():
            faulthandler.enable(file=sys.stderr, all_threads=True)


def load(path, verbose=True):
    """Load an external operator library; it must export
    ``mxtpu_lib_init`` returning 0. The op ABI (float32, each output
    shaped as input 0)::

      int          mxtpu_lib_num_ops();
      const char*  mxtpu_lib_op_name(int idx);
      int          mxtpu_lib_op_num_inputs(int idx);   // optional, default 1
      int mxtpu_lib_op_forward(int idx, int n_inputs, const float** inputs,
                               const int64_t** shapes, const int* ndims,
                               float* output);
      int mxtpu_lib_op_backward(int idx, int n_inputs, const float* out_grad,
                                const float** inputs, const int64_t** shapes,
                                const int* ndims, float* in_grad0);  // optional

    Each op is registered as a ``Custom`` op under its name. Returns the
    ``ctypes.CDLL``."""
    import ctypes
    if not os.path.exists(path):
        raise MXNetError(f"library {path!r} not found")
    lib = ctypes.CDLL(os.path.abspath(path), ctypes.RTLD_LOCAL)
    if not hasattr(lib, "mxtpu_lib_init"):
        raise MXNetError(f"{path}: missing mxtpu_lib_init entry point "
                         "(external op library ABI)")
    ret = lib.mxtpu_lib_init()
    if ret != 0:
        raise MXNetError(f"{path}: mxtpu_lib_init failed with code {ret}")
    names = []
    if hasattr(lib, "mxtpu_lib_num_ops"):
        lib.mxtpu_lib_num_ops.restype = ctypes.c_int
        lib.mxtpu_lib_op_name.restype = ctypes.c_char_p
        lib.mxtpu_lib_op_name.argtypes = [ctypes.c_int]
        has_arity = hasattr(lib, "mxtpu_lib_op_num_inputs")
        if has_arity:
            lib.mxtpu_lib_op_num_inputs.restype = ctypes.c_int
            lib.mxtpu_lib_op_num_inputs.argtypes = [ctypes.c_int]
        for idx in range(lib.mxtpu_lib_num_ops()):
            name = lib.mxtpu_lib_op_name(idx).decode()
            n_in = lib.mxtpu_lib_op_num_inputs(idx) if has_arity else 1
            _register_external_op(lib, idx, name, n_in)
            names.append(name)
    if verbose:
        print(f"loaded library {path}: ops {names}")
    return lib


def _register_external_op(lib, idx, name, n_in=1):
    """Register C op ``idx`` of ``lib`` as the custom op ``name``."""
    import ctypes as c

    import numpy as onp

    from . import operator
    from .ndarray.ndarray import NDArray

    lib.mxtpu_lib_op_forward.restype = c.c_int
    has_bwd = hasattr(lib, "mxtpu_lib_op_backward")
    if has_bwd:
        lib.mxtpu_lib_op_backward.restype = c.c_int

    def _marshal(arrays):
        n = len(arrays)
        bufs = [onp.ascontiguousarray(a, dtype=onp.float32) for a in arrays]
        ins = (c.POINTER(c.c_float) * n)(
            *[b.ctypes.data_as(c.POINTER(c.c_float)) for b in bufs])
        shapes_arrs = [onp.asarray(b.shape, onp.int64) for b in bufs]
        shapes = (c.POINTER(c.c_int64) * n)(
            *[s.ctypes.data_as(c.POINTER(c.c_int64)) for s in shapes_arrs])
        ndims = (c.c_int * n)(*[b.ndim for b in bufs])
        return bufs, ins, shapes, ndims, shapes_arrs

    def _like(dst, host):
        return NDArray(host, ctx=dst.context)

    class _ExternalOp(operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            bufs, ins, shapes, ndims, _keep = _marshal(
                [a.asnumpy() for a in in_data])
            out = onp.zeros_like(bufs[0])
            rc = lib.mxtpu_lib_op_forward(
                idx, len(bufs), ins, shapes, ndims,
                out.ctypes.data_as(c.POINTER(c.c_float)))
            if rc != 0:
                raise MXNetError(f"external op {name}: forward rc={rc}")
            self.assign(out_data[0], req[0], _like(out_data[0], out))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            if not has_bwd:
                for g, r in zip(in_grad, req):
                    self.assign(g, r, _like(g, onp.zeros(g.shape, "float32")))
                return
            bufs, ins, shapes, ndims, _keep = _marshal(
                [a.asnumpy() for a in in_data])
            og = onp.ascontiguousarray(out_grad[0].asnumpy(), onp.float32)
            gin = onp.zeros_like(bufs[0])
            rc = lib.mxtpu_lib_op_backward(
                idx, len(bufs), og.ctypes.data_as(c.POINTER(c.c_float)),
                ins, shapes, ndims,
                gin.ctypes.data_as(c.POINTER(c.c_float)))
            if rc != 0:
                raise MXNetError(f"external op {name}: backward rc={rc}")
            self.assign(in_grad[0], req[0], _like(in_grad[0], gin))
            for g, r in list(zip(in_grad, req))[1:]:
                self.assign(g, r, _like(g, onp.zeros(g.shape, "float32")))

    class _ExternalOpProp(operator.CustomOpProp):
        def __init__(self, **kwargs):
            super().__init__(need_top_grad=True)
            # the arity is the library's (mxtpu_lib_op_num_inputs)
            self._n_in = n_in

        def list_arguments(self):
            return [f"data{i}" for i in range(self._n_in)]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return _ExternalOp()

    operator.register(name)(_ExternalOpProp)
