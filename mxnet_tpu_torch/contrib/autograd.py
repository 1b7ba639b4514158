"""``contrib.autograd`` (the counterpart of
``mxnet_tpu/contrib/autograd.py``, MXNet's pre-1.0 experimental autograd
API) over the port's ``autograd``."""
from ..autograd import (record as train_section,  # noqa: F401
                        pause as test_section,
                        backward as compute_gradient_inner)
from .. import autograd as _ag

__all__ = ["train_section", "test_section", "set_is_training",
           "compute_gradient", "grad_and_loss", "grad"]


def set_is_training(is_train):
    """The legacy switch; returns the previous state."""
    prev = _ag.is_training()
    _ag.set_training(is_train)
    return prev


def compute_gradient(outputs):
    """Gradients of ``outputs`` with respect to the marked variables."""
    _ag.backward(outputs)


def grad_and_loss(func, argnum=None):
    """A function that returns the gradients of ``func``'s arguments (those
    of ``argnum``, else all) and its output."""
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            idx = argnum if isinstance(argnum, list) else [argnum]
            variables = [args[i] for i in idx]
        for x in variables:
            x.attach_grad()
        with _ag.record():
            outputs = func(*args)
        _ag.backward(outputs if isinstance(outputs, list) else [outputs])
        return [x.grad for x in variables], outputs
    return wrapped


def grad(func, argnum=None):
    """A function that returns the gradients only."""
    wrapped = grad_and_loss(func, argnum)

    def only_grad(*args):
        return wrapped(*args)[0]
    return only_grad
