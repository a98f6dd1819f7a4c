"""Measurement scripts of the PyTorch port, run as ``python -m
mxnet_tpu_torch.tools.<name>`` on a machine with the card."""
