"""The original home of the imperative autograd API (counterpart of
``mxnet_tpu/contrib/autograd.py``)."""
from ..autograd import (  # noqa: F401
    backward, compute_gradient, grad, grad_and_loss, mark_variables,
    set_is_training, test_section, train_section,
)
