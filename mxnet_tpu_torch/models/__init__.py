"""Models of the PyTorch port. ``transformer``: the dense transformer LM
and its KV-cached serving twin."""
