"""The fused ``RNN`` operator of the PyTorch port (counterpart of
``mxnet_tpu/ops/rnn_op.py``): multi-layer LSTM / GRU / vanilla RNN over a
(T, N, I) sequence, optionally bidirectional, with the final states as
extra outputs (``state_outputs``) and inter-layer dropout ``p``.

The ``parameters`` blob keeps the JAX package's (and cuDNN's MXNet)
packing, so ``FusedRNNCell.unfuse`` and checkpoints cross both packages:
per layer and direction W_i2h (gates·H, I) then W_h2h (gates·H, H), all
layers' weights first, then all biases [b_i2h, b_h2h]. Gate order: LSTM
i, f, g, o; GRU r, z, n with n = tanh(W_in x + b_in + r·(W_hn h + b_hn)).

The JAX package runs the recurrence as a ``lax.scan`` outside any Pallas
kernel. The port runs it through PyTorch's fused RNN
(``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` / ``rnn_relu``): cuDNN on
the card, as the reference's ``cudnn_rnn-inl.h`` does, and ATen's own loop
on the CPU, one route on both devices. The blob's pieces are reordered
once a call into PyTorch's per-layer order [w_ih, w_hh, b_ih, b_hh] and
copied into one buffer, handed over as views of it: on the card at the
offsets of cuDNN's own weight space (read once a configuration from
``torch._cudnn_rnn_flatten_weight``, what ``flatten_parameters`` uses),
so cuDNN reads them in place instead of compacting them every call.

Dropout between layers draws its masks from the graph's
``torch.Generator`` (``attrs["__rng__"]``), never from torch's global
generator: with ``p > 0`` in training the layers run one call each and the
mask is applied between them. The masks cannot match JAX's threefry bits;
the keep rate and the 1/keep scaling are JAX's (ROADMAP, Queue 3).

:func:`rnn_reference` is the plain version: an explicit per-step loop,
the JAX package's ``_cell_step``, used by nothing on the main path.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import OpDef, register

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        inp = input_size if layer == 0 else state_size * dirs
        size += dirs * gates * state_size * (inp + state_size)  # weights
        size += dirs * gates * state_size * 2  # biases
    return size


def _unpack_params(params, num_layers, input_size, state_size, bidirectional, mode):
    """The blob as ws[layer][dir] = (wi, wh) and bs[layer][dir] = (bi, bh),
    views in the blob's order."""
    gates = _GATES[mode]
    dirs = 2 if bidirectional else 1
    g = gates * state_size
    ws, bs = [], []
    off = 0
    for layer in range(num_layers):
        inp = input_size if layer == 0 else state_size * dirs
        layer_ws = []
        for _ in range(dirs):
            wi = params[off:off + g * inp].reshape(g, inp)
            off += g * inp
            wh = params[off:off + g * state_size].reshape(g, state_size)
            off += g * state_size
            layer_ws.append((wi, wh))
        ws.append(layer_ws)
    for layer in range(num_layers):
        layer_bs = []
        for _ in range(dirs):
            bi = params[off:off + g]
            off += g
            bh = params[off:off + g]
            off += g
            layer_bs.append((bi, bh))
        bs.append(layer_bs)
    return ws, bs


_CUDNN_MODE = {"lstm": "LSTM", "gru": "GRU", "rnn_tanh": "RNN_TANH", "rnn_relu": "RNN_RELU"}
_cudnn_layouts = {}  # (mode, sizes, dtype, device, shapes) -> (length, offsets)


def place(pieces, length, offsets):
    """``pieces`` copied into one zeroed buffer of ``length`` elements at
    ``offsets``, returned as views of it in order (differentiable: one
    concatenation, zero gaps between the pieces)."""
    parts, pos = [], 0
    for i in sorted(range(len(pieces)), key=offsets.__getitem__):
        if offsets[i] > pos:
            parts.append(pieces[i].new_zeros(offsets[i] - pos))
        parts.append(pieces[i].reshape(-1))
        pos = offsets[i] + pieces[i].numel()
    if length > pos:
        parts.append(pieces[0].new_zeros(length - pos))
    flat = torch.cat(parts)
    return [flat[o:o + p.numel()].view(p.shape) for p, o in zip(pieces, offsets)]


def _cudnn_layout(pieces, mode, input_size, hidden, layers, bidir):
    """(length, offset of each piece) of cuDNN's weight space for this RNN,
    or None where cuDNN does not take the pieces. Read once a configuration:
    ``torch._cudnn_rnn_flatten_weight`` lays empty stand-ins out as cuDNN
    wants and leaves each a view into its buffer."""
    p0 = pieces[0]
    if not (p0.is_cuda and torch.backends.cudnn.enabled
            and torch.backends.cudnn.is_acceptable(p0) and torch._use_cudnn_rnn_flatten_weight()):
        return None
    key = (mode, input_size, hidden, layers, bidir, p0.dtype, p0.device,
           tuple(tuple(p.shape) for p in pieces))
    layout = _cudnn_layouts.get(key)
    if layout is None:
        from torch.backends.cudnn import rnn as cudnn_rnn

        stand_ins = [torch.empty(p.shape, dtype=p.dtype, device=p.device) for p in pieces]
        with torch.no_grad():
            buf = torch._cudnn_rnn_flatten_weight(
                stand_ins, 4, input_size, cudnn_rnn.get_cudnn_mode(_CUDNN_MODE[mode]), hidden,
                0, layers, False, bidir)
        layout = _cudnn_layouts[key] = (buf.numel(), [t.storage_offset() for t in stand_ins])
    return layout


def rnn_weights(pieces, mode, input_size, hidden, layers, bidir):
    """The weight list of a ``torch._VF`` RNN call from ``pieces`` (per
    layer and direction w_ih, w_hh, b_ih, b_hh), copied once into one
    buffer and handed over as views of it: on the card at the offsets of
    cuDNN's weight space, which cuDNN then reads in place (no compaction a
    call, no warning); elsewhere end to end."""
    layout = _cudnn_layout(pieces, mode, input_size, hidden, layers, bidir)
    if layout is None:
        offsets, pos = [], 0
        for p in pieces:
            offsets.append(pos)
            pos += p.numel()
        layout = (pos, offsets)
    return place(pieces, *layout)


def _torch_weights(ws, bs, layers, mode, input_size, hidden):
    """Layers ``layers`` of the blob as the weight list of one call."""
    pieces = []
    for layer in layers:
        for (wi, wh), (bi, bh) in zip(ws[layer], bs[layer]):
            pieces += [wi, wh, bi, bh]
    return rnn_weights(pieces, mode, input_size, hidden, len(layers), len(ws[layers[0]]) == 2)


def _dropout_mask(x, p, gen):
    """Inverted dropout of a layer's output, its mask from ``gen``."""
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=gen, device=gen.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _parse(attrs, ins):
    mode = attrs["mode"]
    if mode not in _GATES:
        raise MXNetError("RNN: unknown mode %s" % mode)
    cfg = {
        "mode": mode,
        "num_layers": int(attrs["num_layers"]),
        "H": int(attrs["state_size"]),
        "dirs": 2 if bool(attrs.get("bidirectional", False)) else 1,
        "p": float(attrs.get("p", 0.0)),
        "state_outputs": bool(attrs.get("state_outputs", False)),
    }
    if mode == "lstm":
        data, params, hx, cx = ins[:4]
    else:
        (data, params, hx), cx = ins[:3], None
    return cfg, data, params, hx, cx


def _outputs(cfg, x, h_out, c_out):
    outputs = [x]
    if cfg["state_outputs"]:
        outputs.append(h_out)
        if cfg["mode"] == "lstm":
            outputs.append(c_out)
    return outputs


def _rnn_fcompute(attrs, ins, is_train):
    cfg, data, params, hx, cx = _parse(attrs, ins)
    mode, L, dirs = cfg["mode"], cfg["num_layers"], cfg["dirs"]
    T, N, I = data.shape
    ws, bs = _unpack_params(params, L, I, cfg["H"], dirs == 2, mode)
    gen = attrs.get("__rng__")
    drop = is_train and cfg["p"] > 0 and L > 1 and gen is not None
    # cuDNN keeps the forward's reserve space only in training mode, which
    # a backward needs; dropout is applied here, never inside the call
    train = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
    fn = getattr(torch._VF, mode)  # the four modes are torch._VF's names
    # one call over every layer, or (inter-layer dropout) one a layer
    groups = [list(range(L))] if not drop else [[layer] for layer in range(L)]
    x, h_out, c_out = data, [], []
    for layers in groups:
        rows = slice(layers[0] * dirs, (layers[-1] + 1) * dirs)
        weights = _torch_weights(ws, bs, layers, mode, x.shape[-1], cfg["H"])
        if mode == "lstm":
            x, h, c = fn(x, (hx[rows], cx[rows]), weights, True, len(layers), 0.0, train,
                         dirs == 2, False)
            c_out.append(c)
        else:
            x, h = fn(x, hx[rows], weights, True, len(layers), 0.0, train, dirs == 2, False)
        h_out.append(h)
        if drop and layers[-1] < L - 1:
            x = _dropout_mask(x, cfg["p"], gen)
    h_out = torch.cat(h_out) if len(h_out) > 1 else h_out[0]
    c_out = (torch.cat(c_out) if len(c_out) > 1 else c_out[0]) if c_out else None
    return _outputs(cfg, x, h_out, c_out)


def _cell_step(mode):
    if mode == "lstm":
        def step(h, c, gx, wh, bh):
            i, f, g, o = (gx + h @ wh.T + bh).chunk(4, dim=-1)
            c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            return torch.sigmoid(o) * torch.tanh(c2), c2
    elif mode == "gru":
        def step(h, c, gx, wh, bh):
            xr, xz, xn = gx.chunk(3, dim=-1)
            hr, hz, hn = (h @ wh.T + bh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            return (1.0 - z) * n + z * h, None
    else:
        act = torch.tanh if mode == "rnn_tanh" else torch.relu

        def step(h, c, gx, wh, bh):
            return act(gx + h @ wh.T + bh), None
    return step


def rnn_reference(attrs, ins, is_train):
    """Plain version of the ``RNN`` operator: the JAX package's recurrence,
    one step at a time (the input gates of a layer as one product first),
    the reverse direction over the flipped sequence, and the same dropout
    draws from ``attrs["__rng__"]`` as the operator's."""
    cfg, data, params, hx, cx = _parse(attrs, ins)
    mode, L, dirs = cfg["mode"], cfg["num_layers"], cfg["dirs"]
    T, N, I = data.shape
    ws, bs = _unpack_params(params, L, I, cfg["H"], dirs == 2, mode)
    gen = attrs.get("__rng__")
    step = _cell_step(mode)
    x, h_out, c_out = data, [], []
    for layer in range(L):
        outs = []
        for d in range(dirs):
            s = layer * dirs + d
            wi, wh = ws[layer][d]
            bi, bh = bs[layer][d]
            gates_x = torch.einsum("tni,gi->tng", x, wi) + bi
            if d == 1:
                gates_x = gates_x.flip(0)
            h, c = hx[s], (cx[s] if cx is not None else None)
            ys = []
            for t in range(T):
                h, c = step(h, c, gates_x[t], wh, bh)
                ys.append(h)
            ys = torch.stack(ys)
            outs.append(ys.flip(0) if d == 1 else ys)
            h_out.append(h)
            if mode == "lstm":
                c_out.append(c)
        x = torch.cat(outs, dim=-1) if dirs == 2 else outs[0]
        if is_train and cfg["p"] > 0 and layer < L - 1 and gen is not None:
            x = _dropout_mask(x, cfg["p"], gen)
    return _outputs(cfg, x, torch.stack(h_out), torch.stack(c_out) if c_out else None)


def _rnn_infer(attrs, in_shapes):
    mode = attrs["mode"]
    num_layers = int(attrs["num_layers"])
    H = int(attrs["state_size"])
    bidir = bool(attrs.get("bidirectional", False))
    dirs = 2 if bidir else 1
    state_outputs = bool(attrs.get("state_outputs", False))
    dshape = in_shapes[0]
    if dshape is None:
        raise MXNetError("RNN: data shape required")
    T, N, I = dshape
    psize = _rnn_param_size(num_layers, I, H, bidir, mode)
    sshape = (num_layers * dirs, N, H)
    ishapes = [tuple(dshape), (psize,), sshape]
    if mode == "lstm":
        ishapes.append(sshape)
    oshapes = [(T, N, H * dirs)]
    if state_outputs:
        oshapes.append(sshape)
        if mode == "lstm":
            oshapes.append(sshape)
    return ishapes, oshapes, []


_rnn = OpDef(
    "RNN",
    _rnn_fcompute,
    arguments=("data", "parameters", "state", "state_cell"),
    defaults={
        "mode": "lstm",
        "num_layers": 1,
        "state_size": 0,
        "bidirectional": False,
        "p": 0.0,
        "state_outputs": False,
        "pkeep_": 1.0,
        "lstm_q_": False,
    },
    infer_shape=_rnn_infer,
    needs_rng=True,
)
_rnn.list_arguments = lambda attrs=None: (
    ["data", "parameters", "state", "state_cell"]
    if (attrs or {}).get("mode", "lstm") == "lstm"
    else ["data", "parameters", "state"]
)


def _rnn_outputs(attrs=None):
    a = attrs or {}
    outs = ["output"]
    if a.get("state_outputs"):
        outs.append("state")
        if a.get("mode", "lstm") == "lstm":
            outs.append("state_cell")
    return outs


_rnn.list_outputs = _rnn_outputs
register(_rnn)
