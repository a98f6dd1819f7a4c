"""VGG 11/13/16/19, with or without BatchNorm (counterpart of
``mxnet_tpu/models/vgg.py``): the same symbol, node for node and name for
name, so weights cross packages by name."""
from .. import symbol as sym

_CFG = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False, **kwargs):
    if num_layers not in _CFG:
        raise ValueError("Invalid num_layers %d (11/13/16/19)" % num_layers)
    layers, filters = _CFG[num_layers]
    net = sym.Variable("data")
    for i, num in enumerate(layers):
        for j in range(num):
            net = sym.Convolution(
                net, kernel=(3, 3), pad=(1, 1), num_filter=filters[i],
                name="conv%d_%d" % (i + 1, j + 1)
            )
            if batch_norm:
                net = sym.BatchNorm(net, name="bn%d_%d" % (i + 1, j + 1))
            net = sym.Activation(net, act_type="relu",
                                 name="relu%d_%d" % (i + 1, j + 1))
        net = sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2),
                          name="pool%d" % (i + 1))
    net = sym.Flatten(net, name="flatten")
    net = sym.FullyConnected(net, num_hidden=4096, name="fc6")
    net = sym.Activation(net, act_type="relu", name="relu6")
    net = sym.Dropout(net, p=0.5, name="drop6")
    net = sym.FullyConnected(net, num_hidden=4096, name="fc7")
    net = sym.Activation(net, act_type="relu", name="relu7")
    net = sym.Dropout(net, p=0.5, name="drop7")
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(net, name="softmax")
