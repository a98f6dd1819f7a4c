"""AlexNet, the model of the reference's weak-scaling table at batch 512
(counterpart of ``mxnet_tpu/models/alexnet.py``): the same symbol, node for
node and name for name, so weights cross packages by name."""
from .. import symbol as sym


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    conv1 = sym.Convolution(data, kernel=(11, 11), stride=(4, 4),
                            num_filter=96, name="conv1")
    relu1 = sym.Activation(conv1, act_type="relu")
    lrn1 = sym.LRN(relu1, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    pool1 = sym.Pooling(lrn1, kernel=(3, 3), stride=(2, 2), pool_type="max")
    conv2 = sym.Convolution(pool1, kernel=(5, 5), pad=(2, 2), num_filter=256,
                            name="conv2")
    relu2 = sym.Activation(conv2, act_type="relu")
    lrn2 = sym.LRN(relu2, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
    pool2 = sym.Pooling(lrn2, kernel=(3, 3), stride=(2, 2), pool_type="max")
    conv3 = sym.Convolution(pool2, kernel=(3, 3), pad=(1, 1), num_filter=384,
                            name="conv3")
    relu3 = sym.Activation(conv3, act_type="relu")
    conv4 = sym.Convolution(relu3, kernel=(3, 3), pad=(1, 1), num_filter=384,
                            name="conv4")
    relu4 = sym.Activation(conv4, act_type="relu")
    conv5 = sym.Convolution(relu4, kernel=(3, 3), pad=(1, 1), num_filter=256,
                            name="conv5")
    relu5 = sym.Activation(conv5, act_type="relu")
    pool3 = sym.Pooling(relu5, kernel=(3, 3), stride=(2, 2), pool_type="max")
    flatten = sym.Flatten(pool3)
    fc1 = sym.FullyConnected(flatten, num_hidden=4096, name="fc1")
    relu6 = sym.Activation(fc1, act_type="relu")
    dropout1 = sym.Dropout(relu6, p=0.5)
    fc2 = sym.FullyConnected(dropout1, num_hidden=4096, name="fc2")
    relu7 = sym.Activation(fc2, act_type="relu")
    dropout2 = sym.Dropout(relu7, p=0.5)
    fc3 = sym.FullyConnected(dropout2, num_hidden=num_classes, name="fc3")
    return sym.SoftmaxOutput(fc3, name="softmax")
