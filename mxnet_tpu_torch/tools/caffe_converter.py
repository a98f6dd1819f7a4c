#!/usr/bin/env python
"""Convert Caffe models (.prototxt + .caffemodel) to the PyTorch port's
format (counterpart of ``tools/caffe_converter.py``, whose parsers it
copies).

Parity: reference ``tools/caffe_converter`` (convert_symbol.py +
convert_model.py + caffe_parser.py). The converter is self-contained: a
protobuf wire-format reader plus a prototxt text-format parser cover the
NetParameter subset the model zoo uses, so it needs neither caffe nor a
protobuf package. Field numbers come from the caffe.proto schema (BlobProto
data=5 packed, LayerParameter blobs=7/convolution_param=106/...,
NetParameter layer=100).

Supported layers: Input, Convolution, InnerProduct, Pooling
(MAX/AVE, global, caffe's ceil convention -> pooling_convention=full),
ReLU, Sigmoid, TanH, LRN, Dropout, Softmax(WithLoss), Accuracy
(skipped), Concat, Eltwise (SUM/PROD/MAX), Flatten, BatchNorm
(+ trailing Scale folded into gamma/beta, the reference's merge).
Legacy V1 'layers' nets (the 0.9.5-era model zoo) are normalized to
the modern form on the fly — both text (enum tokens) and binary
(V1LayerParameter name=4/type=5/blobs=6). ``convert_mean`` reads
mean.binaryproto (reference convert_mean.py).

The converted arrays are host arrays (``ctx=mx.cpu()``), as ``mx.nd.load``
gives them; a Module or an executor bound on ``mx.gpu(0)`` copies them to
the card.

Usage:
  python -m mxnet_tpu_torch.tools.caffe_converter model.prototxt model.caffemodel out_prefix
produces out_prefix-symbol.json + out_prefix-0000.params (loadable by
``mx.mod.Module.load`` / ``mx.model.load_checkpoint``).
"""
from __future__ import annotations

import json
import struct
import sys

import numpy as np


# ---------------------------------------------------------------------------
# protobuf wire-format reader (proto2 subset: varint, 64-bit, bytes, 32-bit)
# ---------------------------------------------------------------------------

def _read_varint(buf, i):
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def decode_wire(buf):
    """bytes -> {field_number: [raw values]} (varint ints, bytes for
    length-delimited, 4/8-byte little-endian bytes for fixed)."""
    fields = {}
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, i = _read_varint(buf, i)
        elif wtype == 1:
            val, i = buf[i:i + 8], i + 8
        elif wtype == 2:
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wtype == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError("unsupported wire type %d (field %d)"
                             % (wtype, fnum))
        fields.setdefault(fnum, []).append(val)
    return fields


def _floats(vals):
    """repeated float: packed bytes and/or individual fixed32 entries."""
    out = []
    for v in vals:
        if isinstance(v, (bytes, bytearray)):
            out.extend(struct.unpack("<%df" % (len(v) // 4), v))
        else:  # single fixed32 arrived as 4 raw bytes already handled;
            out.append(struct.unpack("<f", v)[0])
    return out


def _packed_ints(vals):
    out = []
    for v in vals:
        if isinstance(v, (bytes, bytearray)):
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                out.append(x)
        else:
            out.append(v)
    return out


def _f32(vals, default=None):
    if not vals:
        return default
    v = vals[-1]
    if isinstance(v, (bytes, bytearray)):
        return struct.unpack("<f", v)[0]
    return float(v)


def _str(vals, default=None):
    return vals[-1].decode() if vals else default


def _int(vals, default=None):
    return int(vals[-1]) if vals else default


def _bool(vals, default=False):
    return bool(vals[-1]) if vals else default


# ---------------------------------------------------------------------------
# prototxt (protobuf text format) parser
# ---------------------------------------------------------------------------

def parse_prototxt(text):
    """Text-format protobuf -> nested dict; every field is a LIST (the
    caller picks [-1] for optionals). `layer { ... }` nests."""
    pos = [0]
    toks = _tokenize_prototxt(text)

    def parse_block():
        out = {}
        while pos[0] < len(toks):
            t = toks[pos[0]]
            if t == "}":
                pos[0] += 1
                return out
            name = t
            pos[0] += 1
            t = toks[pos[0]]
            if t == "{":
                pos[0] += 1
                out.setdefault(name, []).append(parse_block())
            elif t == ":":
                pos[0] += 1
                val = toks[pos[0]]
                pos[0] += 1
                if val == "{":  # "field: { ... }" variant
                    out.setdefault(name, []).append(parse_block())
                else:
                    out.setdefault(name, []).append(_coerce(val))
            else:
                raise ValueError("prototxt parse error near %r" % t)
        return out

    return parse_block()


def _tokenize_prototxt(text):
    toks = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c in " \t\r\n,":
            i += 1
        elif c in "{}:":
            toks.append(c)
            i += 1
        elif c in "\"'":
            j = text.index(c, i + 1)
            toks.append(text[i:j + 1])
            i = j + 1
        else:
            j = i
            while j < n and text[j] not in " \t\r\n{}:#,":
                j += 1
            toks.append(text[i:j])
            i = j
    return toks


def _coerce(tok):
    if tok and tok[0] in "\"'":
        return tok[1:-1]
    if tok in ("true", "false"):
        return tok == "true"
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        return tok


# ---------------------------------------------------------------------------
# schema accessors (caffe.proto field numbers)
# ---------------------------------------------------------------------------

def _blob_array(blob_fields):
    data = np.asarray(_floats(blob_fields.get(5, [])), np.float32)
    if 7 in blob_fields:  # BlobShape{dim=1 packed}
        shp = _packed_ints(decode_wire(blob_fields[7][-1]).get(1, []))
        return data.reshape([int(d) for d in shp] or [-1])
    dims = [ _int(blob_fields.get(k, []), 0) for k in (1, 2, 3, 4) ]
    dims = [d for d in dims if d]
    return data.reshape(dims or [-1])


# V1LayerParameter.LayerType enum -> modern type string (caffe.proto)
_V1_TYPES = {
    1: "Accuracy", 3: "Concat", 4: "Convolution", 5: "Data",
    6: "Dropout", 8: "Flatten", 14: "InnerProduct", 15: "LRN",
    17: "Pooling", 18: "ReLU", 19: "Sigmoid", 20: "Softmax",
    21: "SoftmaxWithLoss", 23: "TanH", 25: "Eltwise", 36: "Silence",
}


class BinLayer:
    """One LayerParameter (modern field 100) or V1LayerParameter
    (legacy field 2) from a .caffemodel, normalized."""

    def __init__(self, fields, v1=False):
        if v1:
            self.name = _str(fields.get(4, []))
            t = _int(fields.get(5, []))
            self.type = _V1_TYPES.get(t, "V1:%s" % t)
            self.blobs = [_blob_array(decode_wire(b))
                          for b in fields.get(6, [])]
        else:
            self.name = _str(fields.get(1, []))
            self.type = _str(fields.get(2, []))
            self.blobs = [_blob_array(decode_wire(b))
                          for b in fields.get(7, [])]


def parse_caffemodel(path):
    with open(path, "rb") as f:
        net = decode_wire(f.read())
    if 100 in net:
        return [BinLayer(decode_wire(b)) for b in net[100]]
    # legacy V1 'layers' (the 0.9.5-era model zoo is mostly this format)
    return [BinLayer(decode_wire(b), v1=True) for b in net.get(2, [])]


def convert_mean(binaryproto_fname, output_fname=None, mx=None):
    """mean.binaryproto (one BlobProto) -> NDArray; optionally saved as
    a .nd file (reference convert_mean.py surface)."""
    if mx is None:
        import mxnet_tpu_torch as mx
    with open(binaryproto_fname, "rb") as f:
        arr = _blob_array(decode_wire(f.read()))
    nd = mx.nd.array(arr, ctx=mx.cpu())
    if output_fname:
        mx.nd.save(output_fname, {"mean_image": nd})
    return nd


# ---------------------------------------------------------------------------
# symbol conversion (prototxt -> mx.sym)
# ---------------------------------------------------------------------------

def _xy(d, single, h, w, default):
    """caffe's single-value / repeated-(h,w) / explicit h+w convention
    -> (y, x) tuple. `repeated uint32 kernel_size: 3 kernel_size: 2`
    means (h=3, w=2); a single entry means square. A lone pad_h /
    kernel_w etc. is legal caffe (each axis falls back independently):
    the absent side comes from the single-value entry, then the
    default, then the present side — the old d[h]/d[w] double lookup
    raised KeyError (ADVICE r5)."""
    vals = d.get(single, [])
    hv, wv = d.get(h), d.get(w)
    if hv or wv:
        def _side(present, idx):
            if present:
                return int(present[-1])
            if vals:
                return int(vals[idx] if len(vals) > idx else vals[0])
            if default is not None:
                return int(default[idx])
            return int((hv or wv)[-1])

        return (_side(hv, 0), _side(wv, 1))
    if vals:
        if len(vals) >= 2:
            return (int(vals[0]), int(vals[1]))
        return (int(vals[0]),) * 2
    return default


def _scan_bn_scale(layers):
    """Pair Scale layers with the BatchNorm whose TOP they consume —
    caffe splits BN's affine into a following Scale; the reference
    converter merges them. One implementation shared by the symbol and
    the weight pass (they must agree or gamma/beta land on the wrong
    BN). Returns (scaled_bn_names, scale_layer_name -> bn_name)."""
    bn_tops, scaled, scale_to_bn = {}, set(), {}
    for l in layers:
        lt = l.get("type", [""])[-1]
        if lt == "BatchNorm":
            bn_tops[l.get("top", [None])[-1]] = l.get("name", ["?"])[-1]
        elif lt == "Scale":
            b = l.get("bottom", [None])[-1]
            if b in bn_tops:
                scaled.add(bn_tops[b])
                scale_to_bn[l.get("name", [""])[-1]] = bn_tops[b]
    return scaled, scale_to_bn


def _proto_layers(proto):
    """Modern `layer` blocks, or legacy V1 `layers` normalized to them
    (text-format V1 differs only in the block name and the type being an
    enum token like CONVOLUTION instead of the string "Convolution")."""
    if proto.get("layer"):
        return list(proto["layer"])
    v1_by_token = {k.upper().replace("WITHLOSS", "_LOSS"): k
                   for k in _V1_TYPES.values()}
    v1_by_token["SOFTMAX_LOSS"] = "SoftmaxWithLoss"
    v1_by_token["INNER_PRODUCT"] = "InnerProduct"
    out = []
    for l in proto.get("layers", []):
        l = dict(l)
        t = str(l.get("type", [""])[-1])
        l["type"] = [v1_by_token.get(t.upper(), t)]
        if l["type"][-1] == "Data":
            continue  # train-time data layers have no deploy analog
        out.append(l)
    return out


def convert_symbol(prototxt_fname, mx=None):
    """Returns (mx.sym output, input_name, input_dim_or_None)."""
    if mx is None:
        import mxnet_tpu_torch as mx
    with open(prototxt_fname) as f:
        proto = parse_prototxt(f.read())
    layers = _proto_layers(proto)
    # drop train-only phases (include { phase: TRAIN })
    def _is_test(l):
        for inc in l.get("include", []):
            ph = inc.get("phase", [])
            if ph and str(ph[-1]).upper() == "TRAIN":
                return False
        return True
    layers = [l for l in layers if _is_test(l)]

    input_name, input_dim = "data", None
    if proto.get("input"):
        input_name = proto["input"][-1]
        if proto.get("input_dim"):
            input_dim = [int(d) for d in proto["input_dim"]]
        elif proto.get("input_shape"):
            input_dim = [int(d) for d in proto["input_shape"][-1]["dim"]]
    elif layers and layers[0].get("type", [""])[-1] == "Input":
        l0 = layers.pop(0)
        input_name = l0["top"][-1]
        shp = l0.get("input_param", [{}])[-1].get("shape", [{}])[-1]
        input_dim = [int(d) for d in shp.get("dim", [])] or None

    blobs = {input_name: mx.sym.Variable(input_name)}
    out = blobs[input_name]
    scaled_bns, scale_to_bn = _scan_bn_scale(layers)

    for l in layers:
        ltype = l.get("type", [""])[-1]
        name = l.get("name", ["?"])[-1]
        bottoms = [blobs[b] for b in l.get("bottom", [])
                   if b in blobs]
        top = l.get("top", [name])[-1]
        x = bottoms[0] if bottoms else out

        if ltype == "Convolution":
            p = l["convolution_param"][-1]
            kernel = _xy(p, "kernel_size", "kernel_h", "kernel_w", None)
            stride = _xy(p, "stride", "stride_h", "stride_w", (1, 1))
            pad = _xy(p, "pad", "pad_h", "pad_w", (0, 0))
            dil = p.get("dilation", [1])
            dil = ((int(dil[0]), int(dil[1])) if len(dil) >= 2
                   else (int(dil[0]),) * 2)
            node = mx.sym.Convolution(
                x, name=name, kernel=kernel, stride=stride, pad=pad,
                dilate=dil, num_filter=int(p["num_output"][-1]),
                num_group=int(p.get("group", [1])[-1]),
                no_bias=not p.get("bias_term", [True])[-1])
        elif ltype == "InnerProduct":
            p = l["inner_product_param"][-1]
            node = mx.sym.FullyConnected(
                mx.sym.Flatten(x), name=name,
                num_hidden=int(p["num_output"][-1]),
                no_bias=not p.get("bias_term", [True])[-1])
        elif ltype == "Pooling":
            p = l.get("pooling_param", [{}])[-1]
            pool = str(p.get("pool", ["MAX"])[-1]).upper()
            ptype = {"MAX": "max", "AVE": "avg", "0": "max",
                     "1": "avg"}[pool]
            if p.get("global_pooling", [False])[-1]:
                node = mx.sym.Pooling(x, name=name, kernel=(1, 1),
                                      global_pool=True, pool_type=ptype)
            else:
                node = mx.sym.Pooling(
                    x, name=name, pool_type=ptype,
                    kernel=_xy(p, "kernel_size", "kernel_h", "kernel_w",
                               None),
                    stride=_xy(p, "stride", "stride_h", "stride_w",
                               (1, 1)),
                    pad=_xy(p, "pad", "pad_h", "pad_w", (0, 0)),
                    pooling_convention="full")  # caffe pools ceil-mode
        elif ltype == "ReLU":
            node = mx.sym.Activation(x, name=name, act_type="relu")
        elif ltype == "Sigmoid":
            node = mx.sym.Activation(x, name=name, act_type="sigmoid")
        elif ltype == "TanH":
            node = mx.sym.Activation(x, name=name, act_type="tanh")
        elif ltype == "LRN":
            p = l.get("lrn_param", [{}])[-1]
            node = mx.sym.LRN(
                x, name=name,
                alpha=float(p.get("alpha", [1.0])[-1]),
                beta=float(p.get("beta", [0.75])[-1]),
                knorm=float(p.get("k", [1.0])[-1]),
                nsize=int(p.get("local_size", [5])[-1]))
        elif ltype == "Dropout":
            p = l.get("dropout_param", [{}])[-1]
            node = mx.sym.Dropout(
                x, name=name,
                p=float(p.get("dropout_ratio", [0.5])[-1]))
        elif ltype in ("SoftmaxWithLoss", "SoftmaxOutput"):
            node = mx.sym.SoftmaxOutput(x, name="softmax"
                                        if name.startswith("loss")
                                        else name)
        elif ltype == "Softmax":
            node = mx.sym.SoftmaxActivation(x, name=name)
        elif ltype == "Concat":
            node = mx.sym.Concat(*bottoms, name=name)
        elif ltype == "Eltwise":
            p = l.get("eltwise_param", [{}])[-1]
            op = str(p.get("operation", ["SUM"])[-1]).upper()
            if op in ("SUM", "1"):
                node = mx.sym.ElementWiseSum(*bottoms, name=name)
            elif op in ("PROD", "0"):
                node = bottoms[0]
                for b in bottoms[1:]:
                    node = node * b
            else:  # MAX
                node = bottoms[0]
                for b in bottoms[1:]:
                    node = mx.sym.maximum(node, b)
        elif ltype == "Flatten":
            node = mx.sym.Flatten(x, name=name)
        elif ltype == "BatchNorm":
            p = l.get("batch_norm_param", [{}])[-1]
            node = mx.sym.BatchNorm(
                x, name=name, fix_gamma=name not in scaled_bns,
                eps=float(p.get("eps", [1e-5])[-1]),
                use_global_stats=bool(
                    p.get("use_global_stats", [True])[-1]))
        elif ltype == "Scale":
            if name in scale_to_bn:
                # folded into its BatchNorm's gamma/beta
                blobs[top] = x
                out = x
                continue
            raise ValueError("standalone Scale layer %r unsupported"
                             % name)
        elif ltype in ("Accuracy", "Silence"):
            continue
        else:
            raise ValueError("unsupported caffe layer type %r (%s)"
                             % (ltype, name))
        blobs[top] = node
        out = node
    return out, input_name, input_dim


def convert_model(prototxt_fname, caffemodel_fname, output_prefix=None,
                  mx=None):
    """Returns (sym, arg_params, aux_params); writes checkpoint files
    when output_prefix is given (reference convert_model.py surface)."""
    if mx is None:
        import mxnet_tpu_torch as mx
    sym, input_name, input_dim = convert_symbol(prototxt_fname, mx=mx)
    bin_layers = {l.name: l for l in parse_caffemodel(caffemodel_fname)}
    with open(prototxt_fname) as f:
        proto = parse_prototxt(f.read())
    arg_params, aux_params = {}, {}
    # second pass over prototxt to know layer types; BN->Scale pairs by
    # bottom/top topology — the SAME map convert_symbol used, so the
    # folded gamma/beta land on exactly the BN whose fix_gamma was
    # released (file order is not a pairing rule in caffe)
    layers2 = _proto_layers(proto)
    _, scale_to_bn = _scan_bn_scale(layers2)
    for l in layers2:
        ltype = l.get("type", [""])[-1]
        name = l.get("name", [""])[-1]
        bl = bin_layers.get(name)
        if ltype == "Convolution" and bl:
            arg_params[name + "_weight"] = mx.nd.array(bl.blobs[0], ctx=mx.cpu())
            if len(bl.blobs) > 1:
                arg_params[name + "_bias"] = mx.nd.array(bl.blobs[1], ctx=mx.cpu())
        elif ltype == "InnerProduct" and bl:
            w = bl.blobs[0]
            arg_params[name + "_weight"] = mx.nd.array(
                w.reshape(w.shape[-2], -1) if w.ndim > 2 else w, ctx=mx.cpu())
            if len(bl.blobs) > 1:
                arg_params[name + "_bias"] = mx.nd.array(bl.blobs[1], ctx=mx.cpu())
        elif ltype == "BatchNorm" and bl:
            scale = float(bl.blobs[2].reshape(-1)[0]) \
                if len(bl.blobs) > 2 and bl.blobs[2].size else 1.0
            scale = 1.0 / scale if scale else 1.0
            aux_params[name + "_moving_mean"] = mx.nd.array(
                bl.blobs[0].reshape(-1) * scale, ctx=mx.cpu())
            aux_params[name + "_moving_var"] = mx.nd.array(
                bl.blobs[1].reshape(-1) * scale, ctx=mx.cpu())
            # default affine (Scale may overwrite below)
            c = bl.blobs[0].size
            arg_params[name + "_gamma"] = mx.nd.ones((c,), ctx=mx.cpu())
            arg_params[name + "_beta"] = mx.nd.zeros((c,), ctx=mx.cpu())
        elif ltype == "Scale" and bl and name in scale_to_bn:
            bn = scale_to_bn[name]
            arg_params[bn + "_gamma"] = mx.nd.array(
                bl.blobs[0].reshape(-1), ctx=mx.cpu())
            if len(bl.blobs) > 1:
                arg_params[bn + "_beta"] = mx.nd.array(
                    bl.blobs[1].reshape(-1), ctx=mx.cpu())
    if output_prefix:
        with open(output_prefix + "-symbol.json", "w") as f:
            f.write(sym.tojson())
        blob = {"arg:" + k: v for k, v in arg_params.items()}
        blob.update({"aux:" + k: v for k, v in aux_params.items()})
        mx.nd.save(output_prefix + "-0000.params", blob)
    return sym, arg_params, aux_params


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print(__doc__)
        return 1
    prototxt, caffemodel, prefix = argv
    sym, args, auxs = convert_model(prototxt, caffemodel, prefix)
    print(json.dumps({
        "symbol": prefix + "-symbol.json",
        "params": prefix + "-0000.params",
        "args": len(args), "auxs": len(auxs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
