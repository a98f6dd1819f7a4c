"""MLP for MNIST (counterpart of ``mxnet_tpu/models/mlp.py``)."""
from .. import symbol as sym


def get_symbol(num_classes=10, hidden=(128, 64), **kwargs):
    net = sym.Variable("data")
    net = sym.Flatten(net)
    for i, h in enumerate(hidden):
        net = sym.FullyConnected(net, num_hidden=h, name="fc%d" % (i + 1))
        net = sym.Activation(net, act_type="relu", name="relu%d" % (i + 1))
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc%d" % (len(hidden) + 1))
    return sym.SoftmaxOutput(net, name="softmax")
