"""GoogLeNet / Inception-v1: nine inception modules of biased
convolutions, no BatchNorm (counterpart of ``mxnet_tpu/models/googlenet.py``):
the same symbol, node for node and name for name, so weights cross packages
by name."""
from .. import symbol as sym


def _conv(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
          name=None):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name="conv_%s" % name)
    return sym.Activation(c, act_type="relu", name="relu_%s" % name)


def _inception(data, cfg, name):
    n1, n3r, n3, n5r, n5, proj = cfg
    t1 = _conv(data, n1, name="%s_1x1" % name)
    t3 = _conv(data, n3r, name="%s_3x3_reduce" % name)
    t3 = _conv(t3, n3, kernel=(3, 3), pad=(1, 1), name="%s_3x3" % name)
    t5 = _conv(data, n5r, name="%s_5x5_reduce" % name)
    t5 = _conv(t5, n5, kernel=(5, 5), pad=(2, 2), name="%s_5x5" % name)
    p = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                    pool_type="max", name="%s_pool" % name)
    tp = _conv(p, proj, name="%s_proj" % name)
    return sym.Concat(t1, t3, t5, tp, name="ch_concat_%s" % name)


# (n1x1, n3x3reduce, n3x3, n5x5reduce, n5x5, pool_proj) per module;
# None rows are stride-2 max-pool stage boundaries.
_BODY = [
    ("in3a", (64, 96, 128, 16, 32, 32)),
    ("in3b", (128, 128, 192, 32, 96, 64)),
    None,
    ("in4a", (192, 96, 208, 16, 48, 64)),
    ("in4b", (160, 112, 224, 24, 64, 64)),
    ("in4c", (128, 128, 256, 24, 64, 64)),
    ("in4d", (112, 144, 288, 32, 64, 64)),
    ("in4e", (256, 160, 320, 32, 128, 128)),
    None,
    ("in5a", (256, 160, 320, 32, 128, 128)),
    ("in5b", (384, 192, 384, 48, 128, 128)),
]


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    body = _conv(data, 64, kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                 name="conv1")
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pool_type="max",
                       name="pool1")
    body = _conv(body, 64, name="conv2_reduce")
    body = _conv(body, 192, kernel=(3, 3), pad=(1, 1), name="conv2")
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pool_type="max",
                       name="pool2")
    pool_id = 3
    for row in _BODY:
        if row is None:
            body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2),
                               pool_type="max", name="pool%d" % pool_id)
            pool_id += 1
            continue
        name, cfg = row
        body = _inception(body, cfg, name)
    # global (not fixed-7x7) head pool: with the reference's default
    # "valid" pooling convention a 224 input reaches this point at 6x6,
    # which a literal 7x7 window would reject — global_pool matches the
    # intended "average everything" semantics at any input size.
    pool = sym.Pooling(body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="global_pool")
    flat = sym.Flatten(pool, name="flatten")
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
