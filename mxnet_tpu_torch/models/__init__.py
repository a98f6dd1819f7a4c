"""Models of the PyTorch port. ``transformer``: the dense transformer LM
and its KV-cached serving twin. ``resnet``: ResNet v2 as a Symbol graph.
``mlp`` and ``lenet``: the MNIST symbols."""
