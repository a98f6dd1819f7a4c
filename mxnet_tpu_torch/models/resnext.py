"""ResNeXt: post-activation bottlenecks whose 3x3 is a grouped
convolution (counterpart of ``mxnet_tpu/models/resnext.py``): the same
symbol, node for node and name for name, so weights cross packages by
name."""
from .. import symbol as sym

_DEPTHS = {
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}


def _conv_bn(data, num_filter, kernel, stride, pad, name, num_group=1,
             relu=True, bn_mom=0.9):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, num_group=num_group,
                        no_bias=True, name=name + "_conv")
    b = sym.BatchNorm(c, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                      name=name + "_bn")
    if not relu:
        return b
    return sym.Activation(b, act_type="relu", name=name + "_relu")


def _next_unit(data, num_filter, stride, dim_match, num_group, name,
               width_ratio=0.5):
    """Grouped bottleneck: 1x1 down to width, grouped 3x3, 1x1 back up."""
    width = int(num_filter * width_ratio)
    x = _conv_bn(data, width, (1, 1), (1, 1), (0, 0), name + "_1")
    x = _conv_bn(x, width, (3, 3), stride, (1, 1), name + "_2",
                 num_group=num_group)
    x = _conv_bn(x, num_filter, (1, 1), (1, 1), (0, 0), name + "_3",
                 relu=False)
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn(data, num_filter, (1, 1), stride, (0, 0),
                            name + "_sc", relu=False)
    return sym.Activation(x + shortcut, act_type="relu", name=name + "_out")


def get_symbol(num_classes=1000, num_layers=50, num_group=32,
               image_shape="3,224,224", bottleneck_width=0.5, **kwargs):
    """--num-layers / --num-group mirror the reference CLI; the 64x4d
    variant of the goldens table is num_group=64, bottleneck_width=1.0."""
    if num_layers not in _DEPTHS:
        raise ValueError("resnext depth %d not supported (%s)"
                         % (num_layers, sorted(_DEPTHS)))
    units = _DEPTHS[num_layers]
    filters = [64, 256, 512, 1024, 2048]
    height = int(str(image_shape).split(",")[1]) \
        if isinstance(image_shape, str) else image_shape[1]

    data = sym.Variable("data")
    data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=0.9,
                         name="bn_data")
    if height <= 32:
        body = sym.Convolution(data, num_filter=filters[0], kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), no_bias=True,
                               name="conv0")
    else:
        body = _conv_bn(data, filters[0], (7, 7), (2, 2), (3, 3), "stem")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max", name="pool0")
    for i, n_units in enumerate(units):
        stride = (1, 1) if i == 0 else (2, 2)
        body = _next_unit(body, filters[i + 1], stride, False, num_group,
                          "stage%d_unit1" % (i + 1),
                          width_ratio=bottleneck_width)
        for j in range(n_units - 1):
            body = _next_unit(body, filters[i + 1], (1, 1), True, num_group,
                              "stage%d_unit%d" % (i + 1, j + 2),
                              width_ratio=bottleneck_width)
    pool = sym.Pooling(body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="pool1")
    flat = sym.Flatten(pool)
    fc = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc, name="softmax")
