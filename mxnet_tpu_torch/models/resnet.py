"""ResNet v2 (pre-activation), the model of the JAX package's headline
training bench (counterpart of ``mxnet_tpu/models/resnet.py``): the same
symbol, node for node and name for name, so weights cross packages by name.

``init_params``, ``params_from_numpy``, ``grads_to_numpy`` and
``conv_layers`` live in ``models/common.py`` and serve every model; this
module keeps their names for its callers. The cifar branch
(height <= 28) and the imagenet branch are ported; the space-to-depth stem
and a reduced-precision symbol (``dtype != "float32"``) raise until their
operators are.
"""
from __future__ import annotations

from .. import symbol as sym
from .common import conv_layers, grads_to_numpy, init_params, params_from_numpy  # noqa: F401


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True, bn_mom=0.9):
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=num_filter // 4,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=num_filter // 4,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + "_conv1")
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name=name + "_bn2")
    act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter, kernel=(1, 1),
                                   stride=stride, no_bias=True,
                                   name=name + "_sc")
    return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, dtype="float32",
           stem_s2d=False):
    data = sym.Variable("data")
    (nchannel, height, width) = image_shape
    data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                         name="bn_data")
    if dtype != "float32":
        # cast after the input BN, back before the loss head: infer_type
        # makes every weight in between reduced-precision
        data = sym.Cast(data, dtype=dtype, name="cast_in")
    if height <= 32:  # cifar
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    elif stem_s2d:
        # 2x2 space-to-depth turns the 7x7/s2 stem into the exactly
        # equivalent 4x4/s1 conv on 4C channels (asymmetric (2, 1) pad)
        body = sym.Reshape(data, shape=(0, nchannel, height // 2, 2,
                                        width // 2, 2))
        body = sym.transpose(body, axes=(0, 1, 3, 5, 2, 4))
        body = sym.Reshape(body, shape=(0, nchannel * 4, height // 2,
                                        width // 2))
        body = sym.Pad(body, pad_width=(0, 0, 0, 0, 2, 1, 2, 1),
                       mode="constant")
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(4, 4), stride=(1, 1), pad=(0, 0),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                             name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")
    else:  # imagenet
        body = sym.Convolution(data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                             name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")
    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             name="stage%d_unit%d" % (i + 1, 1),
                             bottle_neck=bottle_neck, bn_mom=bn_mom)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name="stage%d_unit%d" % (i + 1, j + 2),
                                 bottle_neck=bottle_neck, bn_mom=bn_mom)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    if dtype != "float32":
        fc1 = sym.Cast(fc1, dtype="float32", name="cast_out")
    return sym.SoftmaxOutput(fc1, name="softmax")


def get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224",
               dtype="float32", stem_s2d=False, **kwargs):
    """Parity with the reference CLI surface: --num-layers picks depth."""
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    (nchannel, height, width) = image_shape
    if height <= 28:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError("no experiments done on num_layers %d" % num_layers)
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        num_stages = 4
        units_map = {
            18: [2, 2, 2, 2],
            34: [3, 4, 6, 3],
            50: [3, 4, 6, 3],
            101: [3, 4, 23, 3],
            152: [3, 8, 36, 3],
            200: [3, 24, 36, 3],
            269: [3, 30, 48, 8],
        }
        if num_layers not in units_map:
            raise ValueError("no experiments done on num_layers %d" % num_layers)
        units = units_map[num_layers]
    return resnet(
        units=units, num_stages=num_stages, filter_list=filter_list,
        num_classes=num_classes, image_shape=image_shape,
        bottle_neck=bottle_neck, dtype=dtype,
        stem_s2d=stem_s2d,
    )
