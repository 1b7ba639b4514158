"""Network visualization of the port (the counterpart of the Gluon-Block
branch of ``mxnet_tpu/visualization.py``'s ``print_summary``): a block's
parameter table and total, with the reference's rows and widths. The
Symbol branch and ``plot_network`` wait for ``symbol`` (ROADMAP Q1.13)."""
from __future__ import annotations

from .base import MXNetError

__all__ = ["print_summary"]


def print_summary(block, input_shape=None, line_length=98):
    """Print one row per parameter of ``block`` (name, shape, count; a
    deferred dimension counts 0) and the total; return the total."""
    from .gluon.block import Block
    if not isinstance(block, Block):
        raise MXNetError("print_summary takes a Gluon Block in the port; "
                         "Symbols wait for the legacy API")
    rows = []
    total_params = 0
    for name, param in block.collect_params().items():
        n = 1
        for s in param.shape or ():
            n *= s
        total_params += n
        rows.append((name, param.shape, n))
    print("=" * line_length)
    print(f"{'Parameter':<60}{'Shape':<25}{'Count':>12}")
    print("=" * line_length)
    for name, shape, n in rows:
        print(f"{name:<60}{str(shape):<25}{n:>12}")
    print("=" * line_length)
    print(f"Total params: {total_params}")
    return total_params
