"""Inception-ResNet-v2: scaled residual blocks over tower tables
(counterpart of ``mxnet_tpu/models/inception_resnet_v2.py``): the same
symbol, node for node and name for name, so weights cross packages by name.
Like the JAX package's, its 17x17 reduce has the paper's 128 filters where
the reference's symbol has 129."""
from .. import symbol as sym


def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), act=True,
          name=None):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name="%s_conv" % name)
    b = sym.BatchNorm(c, fix_gamma=False, eps=2e-5, momentum=0.9,
                      name="%s_bn" % name)
    if not act:
        return b
    return sym.Activation(b, act_type="relu", name="%s_relu" % name)


def _chain(net, specs, name):
    """Run ``net`` through a tower: [(filters, kernel, pad, stride), ...]."""
    for i, (nf, kernel, pad, stride) in enumerate(specs):
        net = _conv(net, nf, kernel, stride=stride, pad=pad,
                    name="%s_%d" % (name, i))
    return net


# tower tables per residual family: (filters, kernel, pad, stride)
def _t(nf, kernel=(1, 1), pad=(0, 0), stride=(1, 1)):
    return (nf, kernel, pad, stride)


_FAMILIES = {
    # 35x35 over 320 channels
    "block35": dict(
        channels=320, scale=0.17,
        towers=[
            [_t(32)],
            [_t(32), _t(32, (3, 3), (1, 1))],
            [_t(32), _t(48, (3, 3), (1, 1)), _t(64, (3, 3), (1, 1))],
        ]),
    # 17x17 over 1088 channels (asymmetric 1x7/7x1 factorization)
    "block17": dict(
        channels=1088, scale=0.10,
        towers=[
            [_t(192)],
            [_t(128), _t(160, (1, 7), (0, 3)), _t(192, (7, 1), (3, 0))],
        ]),
    # 8x8 over 2080 channels (1x3/3x1)
    "block8": dict(
        channels=2080, scale=0.20,
        towers=[
            [_t(192)],
            [_t(192), _t(224, (1, 3), (0, 1)), _t(256, (3, 1), (1, 0))],
        ]),
}


def _res_block(net, family, name, act=True):
    cfg = _FAMILIES[family]
    mixed = sym.Concat(
        *[_chain(net, tower, "%s_t%d" % (name, i))
          for i, tower in enumerate(cfg["towers"])],
        name="%s_mixed" % name)
    up = _conv(mixed, cfg["channels"], (1, 1), act=False,
               name="%s_up" % name)
    net = net + up * cfg["scale"]
    if act:
        net = sym.Activation(net, act_type="relu", name="%s_out" % name)
    return net


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    # stem (299x299 -> 35x35x320)
    net = _conv(data, 32, (3, 3), stride=(2, 2), name="stem1a")
    net = _conv(net, 32, (3, 3), name="stem2a")
    net = _conv(net, 64, (3, 3), pad=(1, 1), name="stem2b")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="stem_pool3a")
    net = _conv(net, 80, (1, 1), name="stem3b")
    net = _conv(net, 192, (3, 3), name="stem4a")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="stem_pool5a")
    mixed_5b = sym.Concat(
        _chain(net, [_t(96)], "m5b_t0"),
        _chain(net, [_t(48), _t(64, (5, 5), (2, 2))], "m5b_t1"),
        _chain(net, [_t(64), _t(96, (3, 3), (1, 1)),
                     _t(96, (3, 3), (1, 1))], "m5b_t2"),
        _chain(sym.Pooling(net, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                           pool_type="avg", name="m5b_pool"),
               [_t(64)], "m5b_t3"),
        name="mixed_5b")
    net = mixed_5b
    for i in range(10):
        net = _res_block(net, "block35", "b35_%d" % i)
    # reduction A (35 -> 17)
    net = sym.Concat(
        _chain(net, [_t(384, (3, 3), (0, 0), (2, 2))], "redA_t0"),
        _chain(net, [_t(256), _t(256, (3, 3), (1, 1)),
                     _t(384, (3, 3), (0, 0), (2, 2))], "redA_t1"),
        sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name="redA_pool"),
        name="reduction_a")
    for i in range(20):
        net = _res_block(net, "block17", "b17_%d" % i)
    # reduction B (17 -> 8)
    net = sym.Concat(
        _chain(net, [_t(256), _t(384, (3, 3), (0, 0), (2, 2))], "redB_t0"),
        _chain(net, [_t(256), _t(288, (3, 3), (0, 0), (2, 2))], "redB_t1"),
        _chain(net, [_t(256), _t(288, (3, 3), (1, 1)),
                     _t(320, (3, 3), (0, 0), (2, 2))], "redB_t2"),
        sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name="redB_pool"),
        name="reduction_b")
    for i in range(9):
        net = _res_block(net, "block8", "b8_%d" % i)
    net = _res_block(net, "block8", "b8_9", act=False)
    net = _conv(net, 1536, (1, 1), name="head")
    net = sym.Pooling(net, global_pool=True, kernel=(1, 1),
                      pool_type="avg", name="global_pool")
    net = sym.Flatten(net, name="flatten")
    net = sym.Dropout(net, p=0.2, name="dropout")
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")
