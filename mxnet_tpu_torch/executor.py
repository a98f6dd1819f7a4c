"""Graph evaluation of the PyTorch port (counterpart of the
``_GraphProgram`` part of ``mxnet_tpu/executor.py``).

``_GraphProgram`` runs a Symbol's nodes in topological order on torch
tensors: a function of (args, aux, is_train) returning (outputs, new aux).
Autograd records the run, so ``torch.autograd.grad`` over the outputs
gives the gradients the JAX package takes with ``jax.grad``. Operators
with auxiliary state (BatchNorm's moving stats) return the updated aux
values after their outputs, and the program collects them by the aux
variables' names. ``Executor`` (bind, forward/backward, grad_req) is the
next slice; mirroring, ``Custom`` ops and random operators are not ported:
a node that needs an rng raises.
"""
from __future__ import annotations

from .base import MXNetError
from .symbol import Symbol, _topo_order


class _GraphProgram:
    """A symbol as a function of (args, aux, is_train) on torch tensors."""

    def __init__(self, symbol: Symbol):
        self.symbol = symbol
        self.nodes = _topo_order([n for n, _ in symbol._outputs])
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_entries = list(symbol._outputs)
        self._var_nodes = {n.name: n for n in self.nodes if n.is_variable}
        for node in self.nodes:
            if not node.is_variable and node.op.needs_rng:
                raise MXNetError(
                    "executor: %s (%s) needs random numbers; random operators are "
                    "not ported to PyTorch yet" % (node.name, node.op.name))

    def __call__(self, arg_values, aux_values, rng, is_train):
        """arg_values / aux_values: dicts name -> tensor; ``rng`` must be
        None (no ported operator draws random numbers). Returns (outputs
        list, new_aux dict)."""
        if rng is not None:
            raise MXNetError("executor: the PyTorch graph program takes no rng")
        env = {}
        for values in (arg_values, aux_values):
            for name, v in values.items():
                node = self._var_nodes.get(name)
                if node is not None:
                    env[(id(node), 0)] = v
        new_aux = {}
        for node in self.nodes:
            if node.is_variable:
                if (id(node), 0) not in env:
                    raise MXNetError("executor: missing input %s" % node.name)
                continue
            attrs = node.canon_attrs()
            in_vals = [env[(id(c), i)] for (c, i) in node.inputs]
            results = node.op.fcompute(attrs, in_vals, is_train)
            n_outs = node.num_outputs()
            for i, v in enumerate(results[:n_outs]):
                env[(id(node), i)] = v
            # trailing results update this node's aux-state variables
            n_args = node._extra.get("n_args", len(node.inputs))
            for (c, _), v in zip(node.inputs[n_args:], results[n_outs:]):
                new_aux[c.name] = v
        outputs = [env[(id(n), i)] for (n, i) in self.output_entries]
        for name in self.aux_names:
            if name not in new_aux:
                new_aux[name] = aux_values[name]
        return outputs, new_aux
