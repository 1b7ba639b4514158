"""``contrib.symbol`` of the port (the counterpart of
``mxnet_tpu/contrib/symbol.py``): the contrib ops through the symbolic
frontend, looked up among ``mx.sym``'s generated wrappers under their own
or their ``_contrib_`` name."""


def __getattr__(name):
    from .. import symbol as _sym
    for cand in (name, f"_contrib_{name}"):
        if hasattr(_sym, cand):
            return getattr(_sym, cand)
    raise AttributeError(f"contrib.symbol has no op {name!r}")
