"""Inception-v3, with its factorized 1x7/7x1 and 1x3/3x1 towers
(counterpart of ``mxnet_tpu/models/inception_v3.py``): the same symbol, node
for node and name for name, so weights cross packages by name."""
from .. import symbol as sym


def _conv(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
          name=None, suffix=""):
    conv = sym.Convolution(
        data, num_filter=num_filter, kernel=kernel, stride=stride, pad=pad,
        no_bias=True, name="%s%s_conv2d" % (name, suffix)
    )
    bn = sym.BatchNorm(conv, eps=2e-5, fix_gamma=False,
                       name="%s%s_batchnorm" % (name, suffix))
    act = sym.Activation(bn, act_type="relu", name="%s%s_relu" % (name, suffix))
    return act


def _pooling(data, kernel, stride, pad, pool_type, name):
    return sym.Pooling(data, kernel=kernel, stride=stride, pad=pad,
                       pool_type=pool_type, name=name)


def inception_a(data, n1, n5r, n5, n3r, n3, proj, name):
    tower_1x1 = _conv(data, n1, name="%s_conv" % name)
    tower_5x5 = _conv(data, n5r, name="%s_tower" % name, suffix="_conv")
    tower_5x5 = _conv(tower_5x5, n5, kernel=(5, 5), pad=(2, 2),
                      name="%s_tower" % name, suffix="_conv_1")
    tower_3x3 = _conv(data, n3r, name="%s_tower_1" % name, suffix="_conv")
    tower_3x3 = _conv(tower_3x3, n3, kernel=(3, 3), pad=(1, 1),
                      name="%s_tower_1" % name, suffix="_conv_1")
    tower_3x3 = _conv(tower_3x3, n3, kernel=(3, 3), pad=(1, 1),
                      name="%s_tower_1" % name, suffix="_conv_2")
    pooling = _pooling(data, (3, 3), (1, 1), (1, 1), "avg",
                       "%s_pool" % name)
    cproj = _conv(pooling, proj, name="%s_tower_2" % name, suffix="_conv")
    return sym.Concat(tower_1x1, tower_5x5, tower_3x3, cproj,
                      name="ch_concat_%s_chconcat" % name)


def inception_b(data, n3, n3x3r, n3x3, name):
    tower_3x3 = _conv(data, n3, kernel=(3, 3), stride=(2, 2),
                      name="%s_conv" % name)
    tower_d3x3 = _conv(data, n3x3r, name="%s_tower" % name, suffix="_conv")
    tower_d3x3 = _conv(tower_d3x3, n3x3, kernel=(3, 3), pad=(1, 1),
                       name="%s_tower" % name, suffix="_conv_1")
    tower_d3x3 = _conv(tower_d3x3, n3x3, kernel=(3, 3), stride=(2, 2),
                       name="%s_tower" % name, suffix="_conv_2")
    pooling = _pooling(data, (3, 3), (2, 2), (0, 0), "max",
                       "max_pool_%s_pool" % name)
    return sym.Concat(tower_3x3, tower_d3x3, pooling,
                      name="ch_concat_%s_chconcat" % name)


def inception_c(data, n1, n7r, n7, nd7r, nd7, proj, name):
    tower_1x1 = _conv(data, n1, name="%s_conv" % name)
    tower_7x7 = _conv(data, n7r, name="%s_tower" % name, suffix="_conv")
    tower_7x7 = _conv(tower_7x7, n7r, kernel=(1, 7), pad=(0, 3),
                      name="%s_tower" % name, suffix="_conv_1")
    tower_7x7 = _conv(tower_7x7, n7, kernel=(7, 1), pad=(3, 0),
                      name="%s_tower" % name, suffix="_conv_2")
    tower_d7 = _conv(data, nd7r, name="%s_tower_1" % name, suffix="_conv")
    tower_d7 = _conv(tower_d7, nd7r, kernel=(7, 1), pad=(3, 0),
                     name="%s_tower_1" % name, suffix="_conv_1")
    tower_d7 = _conv(tower_d7, nd7r, kernel=(1, 7), pad=(0, 3),
                     name="%s_tower_1" % name, suffix="_conv_2")
    tower_d7 = _conv(tower_d7, nd7r, kernel=(7, 1), pad=(3, 0),
                     name="%s_tower_1" % name, suffix="_conv_3")
    tower_d7 = _conv(tower_d7, nd7, kernel=(1, 7), pad=(0, 3),
                     name="%s_tower_1" % name, suffix="_conv_4")
    pooling = _pooling(data, (3, 3), (1, 1), (1, 1), "avg",
                       "%s_pool" % name)
    cproj = _conv(pooling, proj, name="%s_tower_2" % name, suffix="_conv")
    return sym.Concat(tower_1x1, tower_7x7, tower_d7, cproj,
                      name="ch_concat_%s_chconcat" % name)


def inception_d(data, n3r, n3, n7r, n7, name):
    tower_3x3 = _conv(data, n3r, name="%s_tower" % name, suffix="_conv")
    tower_3x3 = _conv(tower_3x3, n3, kernel=(3, 3), stride=(2, 2),
                      name="%s_tower" % name, suffix="_conv_1")
    tower_7x7 = _conv(data, n7r, name="%s_tower_1" % name, suffix="_conv")
    tower_7x7 = _conv(tower_7x7, n7r, kernel=(1, 7), pad=(0, 3),
                      name="%s_tower_1" % name, suffix="_conv_1")
    tower_7x7 = _conv(tower_7x7, n7r, kernel=(7, 1), pad=(3, 0),
                      name="%s_tower_1" % name, suffix="_conv_2")
    tower_7x7 = _conv(tower_7x7, n7, kernel=(3, 3), stride=(2, 2),
                      name="%s_tower_1" % name, suffix="_conv_3")
    pooling = _pooling(data, (3, 3), (2, 2), (0, 0), "max",
                       "max_pool_%s_pool" % name)
    return sym.Concat(tower_3x3, tower_7x7, pooling,
                      name="ch_concat_%s_chconcat" % name)


def inception_e(data, n1, n3r, n3, nd3r, nd3, proj, name):
    tower_1x1 = _conv(data, n1, name="%s_conv" % name)
    tower_3x3 = _conv(data, n3r, name="%s_tower" % name, suffix="_conv")
    t3a = _conv(tower_3x3, n3, kernel=(1, 3), pad=(0, 1),
                name="%s_tower" % name, suffix="_mixed_conv")
    t3b = _conv(tower_3x3, n3, kernel=(3, 1), pad=(1, 0),
                name="%s_tower" % name, suffix="_mixed_conv_1")
    tower_d3 = _conv(data, nd3r, name="%s_tower_1" % name, suffix="_conv")
    tower_d3 = _conv(tower_d3, nd3, kernel=(3, 3), pad=(1, 1),
                     name="%s_tower_1" % name, suffix="_conv_1")
    td3a = _conv(tower_d3, nd3, kernel=(1, 3), pad=(0, 1),
                 name="%s_tower_1" % name, suffix="_mixed_conv")
    td3b = _conv(tower_d3, nd3, kernel=(3, 1), pad=(1, 0),
                 name="%s_tower_1" % name, suffix="_mixed_conv_1")
    pooling = _pooling(data, (3, 3), (1, 1), (1, 1), "avg", "%s_pool" % name)
    cproj = _conv(pooling, proj, name="%s_tower_2" % name, suffix="_conv")
    return sym.Concat(tower_1x1, t3a, t3b, td3a, td3b, cproj,
                      name="ch_concat_%s_chconcat" % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    # stem
    conv = _conv(data, 32, kernel=(3, 3), stride=(2, 2), name="conv")
    conv_1 = _conv(conv, 32, kernel=(3, 3), name="conv_1")
    conv_2 = _conv(conv_1, 64, kernel=(3, 3), pad=(1, 1), name="conv_2")
    pool = _pooling(conv_2, (3, 3), (2, 2), (0, 0), "max", "pool")
    conv_3 = _conv(pool, 80, kernel=(1, 1), name="conv_3")
    conv_4 = _conv(conv_3, 192, kernel=(3, 3), name="conv_4")
    pool1 = _pooling(conv_4, (3, 3), (2, 2), (0, 0), "max", "pool1")
    # 3 x inception A
    in3a = inception_a(pool1, 64, 48, 64, 64, 96, 32, "mixed")
    in3b = inception_a(in3a, 64, 48, 64, 64, 96, 64, "mixed_1")
    in3c = inception_a(in3b, 64, 48, 64, 64, 96, 64, "mixed_2")
    # reduction B
    in3d = inception_b(in3c, 384, 64, 96, "mixed_3")
    # 4 x inception C
    in4a = inception_c(in3d, 192, 128, 192, 128, 192, 192, "mixed_4")
    in4b = inception_c(in4a, 192, 160, 192, 160, 192, 192, "mixed_5")
    in4c = inception_c(in4b, 192, 160, 192, 160, 192, 192, "mixed_6")
    in4d = inception_c(in4c, 192, 192, 192, 192, 192, 192, "mixed_7")
    # reduction D
    in4e = inception_d(in4d, 192, 320, 192, 192, "mixed_8")
    # 2 x inception E
    in5a = inception_e(in4e, 320, 384, 384, 448, 384, 192, "mixed_9")
    in5b = inception_e(in5a, 320, 384, 384, 448, 384, 192, "mixed_10")
    pool2 = sym.Pooling(in5b, kernel=(8, 8), global_pool=True,
                        pool_type="avg", name="global_pool")
    flatten = sym.Flatten(pool2, name="flatten")
    fc1 = sym.FullyConnected(flatten, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")
