"""Network visualization of the port (the counterpart of
``mxnet_tpu/visualization.py``; MXNet's print_summary:25 and
plot_network:214), with the reference's rows, widths and dot text:
``print_summary`` over a Symbol (one row per op, output shapes from shape
inference, parameter counts) or a Gluon Block (one row per parameter);
``plot_network`` builds graphviz dot source for a Symbol's op DAG
(shape-labelled edges, the reference's colours) or a Block's hierarchy, and
wraps it in ``graphviz.Source`` when that optional package is
importable."""
from __future__ import annotations

from .base import MXNetError

# reference plot_network fill colors by op family (visualization.py:266)
_COLORS = {
    "Convolution": "#fb8072", "Deconvolution": "#fb8072",
    "FullyConnected": "#fb8072",
    "Activation": "#ffffb3", "LeakyReLU": "#ffffb3",
    "BatchNorm": "#bebada", "LayerNorm": "#bebada",
    "Pooling": "#80b1d3",
    "Concat": "#fdb462", "Flatten": "#fdb462", "Reshape": "#fdb462",
    "softmax": "#fccde5", "SoftmaxOutput": "#fccde5",
}
_DEFAULT_COLOR = "#8dd3c7"
_VAR_COLOR = "#8dd3c7"


def print_summary(block, input_shape=None, line_length=98):
    """Print a per-layer summary table (visualization.py:25). Accepts a
    Symbol (op-level rows, output shapes from infer_shape — the reference
    signature) or a gluon Block (parameter rows)."""
    from .gluon.block import Block
    from .symbol.symbol import Symbol
    if isinstance(block, Symbol):
        return _print_symbol_summary(block, input_shape, line_length)
    if not isinstance(block, Block):
        raise MXNetError("print_summary takes a Symbol or a Gluon Block, "
                         f"got {type(block).__name__}")
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


def _print_symbol_summary(sym, shape, line_length):
    """Per-node table for a Symbol: op, output shape, param count, inputs
    (the reference print_summary layout, visualization.py:25-196)."""
    arg_shapes = {}
    node_shapes = {}
    if shape:
        try:
            from .symbol.executor import _infer_shapes
            shapes, _, _ = _infer_shapes(
                sym, {k: tuple(v) for k, v in shape.items()},
                node_shapes_out=node_shapes)
            arg_shapes = dict(shapes)  # already {arg_name: shape}
        except Exception:  # noqa: BLE001 — shapes are decoration only
            pass
    total_params = 0
    param_suffixes = ("weight", "bias", "gamma", "beta", "moving_mean",
                      "moving_var", "running_mean", "running_var")
    counted = set()  # a shared variable counts once, not per consumer
    print("=" * line_length)
    print(f"{'Layer (type)':<36}{'Output Shape':<24}{'Param #':>10}  "
          f"{'Previous Layer':<26}")
    print("=" * line_length)
    for n in sym._topo():
        if n.is_var:
            continue
        params = 0
        prev = []
        for slot in n.inputs:
            if slot is None:
                continue
            src, _ = slot
            if src.is_var:
                shp = arg_shapes.get(src.name)
                if shp and src.name.endswith(param_suffixes) and \
                        src.name not in counted:
                    counted.add(src.name)
                    cnt = 1
                    for s in shp:
                        cnt *= s
                    params += cnt
            else:
                prev.append(src.name)
        total_params += params
        outs = node_shapes.get(id(n))
        out_shape = "x".join(map(str, outs[0])) if outs and outs[0] else ""
        print(f"{n.name + ' (' + n.op + ')':<36}{out_shape:<24}"
              f"{params:>10}  {','.join(prev[:2]):<26}")
    print("=" * line_length)
    print(f"Total params: {total_params}")
    return total_params


def _label(node):
    attrs = node.attrs or {}
    if node.op == "Convolution":
        k = attrs.get("kernel")
        return f"Convolution\\n{k}/{attrs.get('stride', (1, 1))}, " \
               f"{attrs.get('num_filter', '?')}"
    if node.op == "FullyConnected":
        return f"FullyConnected\\n{attrs.get('num_hidden', '?')}"
    if node.op == "Pooling":
        return f"Pooling\\n{attrs.get('pool_type', 'max')}, " \
               f"{attrs.get('kernel')}/{attrs.get('stride', (1, 1))}"
    if node.op == "Activation":
        return f"Activation\\n{attrs.get('act_type', '')}"
    return node.op


def _plot_symbol(sym, title, shape, hide_weights):
    lines = [f'digraph "{title}" {{',
             "  node [shape=box, fixedsize=true, width=1.3, height=0.8034, "
             "style=filled];"]
    shapes = {}
    if shape:
        try:
            arg_shapes, out_shapes, _ = sym.infer_shape(**shape)
            shapes = dict(zip(sym.list_arguments(), arg_shapes))
        except Exception:  # noqa: BLE001 — shapes are decoration only
            shapes = {}
    topo = sym._topo()
    hidden = set()
    if hide_weights:
        for n in topo:
            if n.is_var and not n.name.endswith("data") and \
                    any(n.name.endswith(s) for s in
                        ("weight", "bias", "gamma", "beta", "moving_mean",
                         "moving_var", "running_mean", "running_var")):
                hidden.add(id(n))
    for n in topo:
        if id(n) in hidden:
            continue
        if n.is_var:
            lines.append(f'  "{n.name}" [label="{n.name}", '
                         f'fillcolor="{_VAR_COLOR}"];')
        else:
            color = _COLORS.get(n.op, _DEFAULT_COLOR)
            lines.append(f'  "{n.name}" [label="{_label(n)}", '
                         f'fillcolor="{color}"];')
    for n in topo:
        if n.is_var or id(n) in hidden:
            continue
        for slot in n.inputs:
            if slot is None:
                continue
            src, _ = slot
            if id(src) in hidden:
                continue
            edge = f'  "{src.name}" -> "{n.name}"'
            if src.name in shapes:
                edge += f' [label="{"x".join(map(str, shapes[src.name]))}"]'
            lines.append(edge + ";")
    lines.append("}")
    return "\n".join(lines)


def _plot_block(block, title):
    lines = [f'digraph "{title}" {{',
             '  node [shape=box, style=filled, fillcolor="#8dd3c7"];']

    def walk(b, prefix):
        node = prefix or b.__class__.__name__
        lines.append(f'  "{node}" [label="{b.__class__.__name__}"];')
        for name, child in b._modules.items():
            child_id = f"{node}/{name}"
            walk(child, child_id)
            lines.append(f'  "{child_id}" -> "{node}";')
    walk(block, "")
    lines.append("}")
    return "\n".join(lines)


def plot_network(symbol, title="plot", shape=None, save_format="pdf",
                 hide_weights=True):
    """Graphviz plot of a Symbol's op DAG — shape-labeled edges, reference
    color scheme (visualization.py:214) — or of a gluon Block's hierarchy.
    Rendering needs the optional graphviz package; dot text is always built."""
    from .symbol.symbol import Symbol
    if isinstance(symbol, Symbol):
        src = _plot_symbol(symbol, title, shape, hide_weights)
    else:
        src = _plot_block(symbol, title)
    try:
        import graphviz
        return graphviz.Source(src)
    except ImportError:
        return src
