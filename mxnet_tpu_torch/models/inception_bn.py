"""Inception-BN (Inception-v2) (counterpart of
``mxnet_tpu/models/inception_bn.py``): the same symbol, node for node and
name for name, so weights cross packages by name."""
from .. import symbol as sym

_EPS = 1e-10 + 1e-5


def _conv(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
          name=None):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name="conv_%s" % name)
    b = sym.BatchNorm(c, eps=_EPS, fix_gamma=False, momentum=0.9,
                      name="bn_%s" % name)
    return sym.Activation(b, act_type="relu", name="relu_%s" % name)


def _block_keep(data, cfg, name):
    """Same-resolution inception block: 1x1 | 3x3 | double-3x3 | pool+proj."""
    n1, n3r, n3, nd3r, nd3, pool, proj = cfg
    t1 = _conv(data, n1, name="%s_1x1" % name)
    t3 = _conv(data, n3r, name="%s_3x3_reduce" % name)
    t3 = _conv(t3, n3, kernel=(3, 3), pad=(1, 1), name="%s_3x3" % name)
    td = _conv(data, nd3r, name="%s_double_3x3_reduce" % name)
    td = _conv(td, nd3, kernel=(3, 3), pad=(1, 1),
               name="%s_double_3x3_0" % name)
    td = _conv(td, nd3, kernel=(3, 3), pad=(1, 1),
               name="%s_double_3x3_1" % name)
    p = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type=pool, name="%s_pool" % name)
    tp = _conv(p, proj, name="%s_proj" % name)
    return sym.Concat(t1, t3, td, tp, name="ch_concat_%s" % name)


def _block_reduce(data, cfg, name):
    """Stride-2 reduction block: 3x3/2 | double-3x3/2 | maxpool/2."""
    n3r, n3, nd3r, nd3 = cfg
    t3 = _conv(data, n3r, name="%s_3x3_reduce" % name)
    t3 = _conv(t3, n3, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
               name="%s_3x3" % name)
    td = _conv(data, nd3r, name="%s_double_3x3_reduce" % name)
    td = _conv(td, nd3, kernel=(3, 3), pad=(1, 1),
               name="%s_double_3x3_0" % name)
    td = _conv(td, nd3, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
               name="%s_double_3x3_1" % name)
    p = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                    pool_type="max", name="%s_pool" % name)
    return sym.Concat(t3, td, p, name="ch_concat_%s" % name)


# (block kind, name, config) — the published Inception-BN body.
_BODY = [
    ("keep", "3a", (64, 64, 64, 64, 96, "avg", 32)),
    ("keep", "3b", (64, 64, 96, 64, 96, "avg", 64)),
    ("reduce", "3c", (128, 160, 64, 96)),
    ("keep", "4a", (224, 64, 96, 96, 128, "avg", 128)),
    ("keep", "4b", (192, 96, 128, 96, 128, "avg", 128)),
    ("keep", "4c", (160, 128, 160, 128, 160, "avg", 128)),
    ("keep", "4d", (96, 128, 192, 160, 192, "avg", 128)),
    ("reduce", "4e", (128, 192, 192, 256)),
    ("keep", "5a", (352, 192, 320, 160, 224, "avg", 128)),
    ("keep", "5b", (352, 192, 320, 192, 224, "max", 128)),
]


def get_symbol(num_classes=1000, image_shape="3,224,224", **kwargs):
    height = int(image_shape.split(",")[1])
    data = sym.Variable("data")
    if height <= 28:
        # compact variant for small images (reference keeps one too)
        body = _conv(data, 96, kernel=(3, 3), pad=(1, 1), name="1")
        for name, (n1, n3) in [("in3a", (32, 32)), ("in3b", (32, 48))]:
            c1 = _conv(body, n1, name="%s_1x1" % name)
            c3 = _conv(body, n3, kernel=(3, 3), pad=(1, 1),
                       name="%s_3x3" % name)
            body = sym.Concat(c1, c3, name="%s_concat" % name)
        body = _block_reduce(body, (40, 80, 24, 48), "in3c")
        pool = sym.Pooling(body, global_pool=True, kernel=(7, 7),
                           pool_type="avg", name="global_pool")
    else:
        body = _conv(data, 64, kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                     name="1")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2),
                           pool_type="max", name="pool_1")
        body = _conv(body, 64, name="2_red")
        body = _conv(body, 192, kernel=(3, 3), pad=(1, 1), name="2")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2),
                           pool_type="max", name="pool_2")
        for kind, name, cfg in _BODY:
            body = (_block_keep if kind == "keep" else _block_reduce)(
                body, cfg, name)
        # global head pool: identical to the reference's 7x7 window at
        # 224 input (where the map IS 7x7), and well-defined at other
        # input sizes where a literal 7x7 valid window would be rejected
        pool = sym.Pooling(body, global_pool=True, kernel=(7, 7),
                           pool_type="avg", name="global_pool")
    flat = sym.Flatten(pool, name="flatten")
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
