"""Models of the PyTorch port, each a module whose symbol function is
``get_symbol`` (the module names are not rebound to those functions, as
the JAX package's ``models/__init__.py`` does). ``transformer``: the dense
transformer LM and its KV-cached serving twin. ``resnet``: ResNet v2. The
image-classification zoo: ``alexnet``, ``vgg``, ``googlenet``,
``inception_bn``, ``inception_v3``, ``inception_resnet_v2``, ``resnext``.
``mlp`` and ``lenet``: the MNIST symbols. ``common``: the parameter
initialisation, the numpy <-> torch carriage and the convolution list they
share."""
