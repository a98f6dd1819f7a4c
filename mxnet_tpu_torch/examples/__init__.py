"""Runnable examples of the PyTorch port, ports of the JAX package's
``examples/`` (``python -m mxnet_tpu_torch.examples.<name>``)."""
