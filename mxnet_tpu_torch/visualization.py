"""Network visualization of the port: layer summary table + graphviz plot
(counterpart of ``mxnet_tpu/visualization.py``).

Capability parity with reference ``python/mxnet/visualization.py``
(print_summary, plot_network), re-designed to walk the Symbol graph
directly instead of round-tripping through graph JSON, and to count
parameters from the actually-inferred argument shapes rather than the
reference's per-op-type arithmetic (which under-counts anything it has
no special case for).
"""
from __future__ import annotations

from .symbol import Symbol, _topo_order


def _walk(symbol):
    """(nodes in topo order, head node set) for a Symbol."""
    nodes = _topo_order([n for n, _ in symbol._outputs])
    heads = {id(n) for n, _ in symbol._outputs}
    return nodes, heads


def _fmt_shape(shape):
    return "x".join(str(d) for d in shape)


def print_summary(symbol, shape=None, line_length=120,
                  positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a Keras-style table: layer, output shape, #params, inputs.

    Parameter counts are exact: every variable feeding a layer (weights,
    biases, gammas...) contributes its inferred size."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be Symbol")
    out_shapes = {}
    arg_shapes = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, shapes, _ = internals.infer_shape(**shape)
        if shapes is None:
            raise ValueError("Input shape is incomplete")
        out_shapes = dict(zip(internals.list_outputs(), shapes))
        arg_shapes = dict(zip(symbol.list_arguments(),
                              symbol.infer_shape(**shape)[0]))

    cols = [int(line_length * p) if p <= 1 else p for p in positions]

    def emit(fields):
        line = ""
        for width, field in zip(cols, fields):
            line = (line + str(field))[:width].ljust(width)
        print(line)

    nodes, heads = _walk(symbol)
    first = nodes[0] if nodes else None
    # inputs (given shapes, labels) are fed, not learned
    non_params = set(shape or ()) | {
        n for n in arg_shapes if n.endswith("label")}

    print("_" * line_length)
    emit(["Layer (type)", "Output Shape", "Param #", "Previous Layer"])
    print("=" * line_length)

    total = 0
    rows = []
    for node in nodes:
        if node.is_variable and node is not first and id(node) not in heads:
            continue  # parameters are counted into their layer's row
        if node.is_variable:
            op_name = "null"
            prev = []
            n_params = 0
        else:
            op_name = node.op.name
            prev = [c.name for (c, _i) in node.inputs
                    if not c.is_variable or id(c) in heads]
            # exact: sum the sizes of this node's parameter variables
            n_params = 0
            for (c, _i) in node.inputs:
                if c.is_variable and c.name in arg_shapes and \
                        c.name not in non_params:
                    s = arg_shapes[c.name]
                    size = 1
                    for d in s:
                        size *= int(d)
                    n_params += size
        key = node.name if node.is_variable else node.name + "_output"
        oshape = out_shapes.get(key, ())
        oshape = oshape[1:] if oshape else []
        rows.append((node, op_name, oshape, n_params, prev))
        total += n_params

    for i, (node, op_name, oshape, n_params, prev) in enumerate(rows):
        emit(["%s(%s)" % (node.name, op_name), _fmt_shape(oshape),
              n_params, prev[0] if prev else ""])
        for extra in prev[1:]:
            emit(["", "", "", extra])
        print(("=" if i == len(rows) - 1 else "_") * line_length)
    print("Total params: %s" % total)
    print("_" * line_length)
    return total


_PARAM_SUFFIXES = ("_weight", "_bias", "_gamma", "_beta",
                   "_moving_var", "_moving_mean")

# fillcolor + label builder per op family (colorbrewer Set3)
_STYLE = {
    "Convolution": ("#fb8072", lambda a: "Convolution\n%s/%s, %s" % (
        a.get("kernel", ""), a.get("stride", "1"), a.get("num_filter", ""))),
    "FullyConnected": ("#fb8072", lambda a: "FullyConnected\n%s"
                       % a.get("num_hidden", "")),
    "Activation": ("#ffffb3", lambda a: "Activation\n%s"
                   % a.get("act_type", "")),
    "LeakyReLU": ("#ffffb3", lambda a: "LeakyReLU\n%s"
                  % a.get("act_type", "")),
    "BatchNorm": ("#bebada", None),
    "Pooling": ("#80b1d3", lambda a: "Pooling\n%s, %s/%s" % (
        a.get("pool_type", ""), a.get("kernel", ""), a.get("stride", "1"))),
    "Concat": ("#fdb462", None),
    "Flatten": ("#fdb462", None),
    "Reshape": ("#fdb462", None),
    "Softmax": ("#b3de69", None),
}


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Build a graphviz Digraph of the network (raises without graphviz)."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError("Draw network requires graphviz library") from e
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")

    out_shapes = {}
    if shape is not None:
        internals = symbol.get_internals()
        _, shapes, _ = internals.infer_shape(**shape)
        out_shapes = dict(zip(internals.list_outputs(), shapes))

    base_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    base_attr.update(node_attrs or {})
    dot = Digraph(name=title, format=save_format)

    nodes, _heads = _walk(symbol)
    hidden = set()
    for node in nodes:
        attr = dict(base_attr)
        if node.is_variable:
            if hide_weights and node.name.endswith(_PARAM_SUFFIXES):
                hidden.add(node.name)
                continue
            attr.update(shape="oval", fillcolor="#8dd3c7")
            dot.node(name=node.name, label=node.name, **attr)
            continue
        color, labeler = _STYLE.get(node.op.name, ("#fccde5", None))
        attrs = {k: str(v) for k, v in node.attrs.items()}
        label = labeler(attrs) if labeler else node.name
        attr["fillcolor"] = color
        dot.node(name=node.name, label=label, **attr)

    for node in nodes:
        if node.is_variable:
            continue
        for (src, _i) in node.inputs:
            if src.name in hidden:
                continue
            edge = {"dir": "back", "arrowtail": "open"}
            key = src.name if src.is_variable else src.name + "_output"
            if key in out_shapes:
                edge["label"] = _fmt_shape(out_shapes[key][1:])
            dot.edge(tail_name=node.name, head_name=src.name, **edge)
    return dot
