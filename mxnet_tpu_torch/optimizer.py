"""Optimizers of the PyTorch port (counterpart of ``mxnet_tpu/optimizer.py``):
the registry, SGD / NAG / ccSGD / DCASGD / Adam / AdaGrad / RMSProp /
AdaDelta / Ftrl / Test, the ``Updater`` closure, lr / wd multipliers,
clipping and the lr_scheduler wiring.

Every update runs eagerly on NDArrays through the port's operators: SGD,
Adam and RMSProp through the fused update operators of
``ops/optimizer_ops.py``, the others through ``_begin_update`` and NDArray
arithmetic, in the JAX package's order of operations. The fused trainer
(``parallel/train_step.py``) calls the same ``update`` on flat slabs; under
AMP, optimizers whose ``fused_slab_kernel`` is set run kernel K1 instead.
``SGLD`` draws its noise from a generator of its own, which cannot repeat
the JAX package's threefry draws.
"""
from __future__ import annotations

import logging
import pickle

import torch

from . import ndarray as nd
from . import random as _random


class Optimizer:
    opt_registry = {}

    @staticmethod
    def register(klass):
        key = klass.__name__.lower()
        if key in Optimizer.opt_registry:
            logging.warning("New optimizer %s overriding existing one", key)
        Optimizer.opt_registry[key] = klass
        return klass

    @staticmethod
    def create_optimizer(name, rescale_grad=1, **kwargs):
        try:
            cls = Optimizer.opt_registry[name.lower()]
        except KeyError:
            raise ValueError("Cannot find optimizer %s" % name)
        return cls(rescale_grad=rescale_grad, **kwargs)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None, sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        assert param_idx2name is None or isinstance(param_idx2name, dict)
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.set_lr_mult({})
        self.set_wd_mult({})

    # -- per-parameter hyperparameters ---------------------------------
    def _sym_attr_mults(self, attr_key):
        """__lr_mult__ / __wd_mult__ attributes of the bound symbol."""
        out = {}
        if self.sym is not None:
            attrs = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if attr_key in attrs.get(name, {}):
                    out[name] = float(attrs[name][attr_key])
        return out

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_attr_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        # weight decay is off for anything that is not a weight or a gamma
        # (biases, BN betas): the reference's convention
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._sym_attr_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _mult_for(self, index, table):
        if index in table:
            return table[index]
        return table.get(self.idx2name.get(index), 1.0)

    def _get_lr(self, index):
        base = (self.lr_scheduler(self.num_update) if self.lr_scheduler is not None
                else self.lr)
        return base * self._mult_for(index, self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult_for(index, self.wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    # -- shared eager-update pipeline ----------------------------------
    def _begin_update(self, index, grad):
        """(lr, wd) resolved BEFORE the update count moves, so a scheduler
        sees the pre-update count, then the rescaled, clipped grad."""
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        return lr, wd, self._condition_grad(grad)

    def _condition_grad(self, grad):
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = nd.clip(g, a_min=-self.clip_gradient, a_max=self.clip_gradient)
        return g

    def _fused_kwargs(self, index):
        """Common kwargs of the fused update operators (lr resolved before
        the count moves, as in _begin_update)."""
        lr, wd = self._get_lr(index), self._get_wd(index)
        self._update_count(index)
        return {"lr": lr, "wd": wd, "rescale_grad": self.rescale_grad,
                "clip_gradient": self.clip_gradient or -1.0}

    def fused_lr(self, index, lr):
        """The lr the fused update operator takes at ``index``, from the
        scheduled ``lr`` of :meth:`_fused_kwargs` (Adam folds its bias
        correction in)."""
        return lr

    def _op_lr(self, index, lr):
        """The lr the update operator reads: ``fused_lr``. A grouped step
        (``ShardedTrainStep.call_multi``) shadows it for one micro-step
        with a device view of that step's ``fused_lr``, which the host
        wrote before the step ran (a captured step reads it at each
        replay)."""
        return self.fused_lr(index, lr)

    # True when update() is a pure elementwise function of (weight, grad,
    # state) given the scalar hyperparameters: such an optimizer runs on
    # any flat re-layout of the parameters, which the flat update of the
    # fused trainer does.
    elementwise_update = False

    # The K1 variant (ops/kernels.fused_slab_update) the AMP flat update
    # runs for this optimizer: "sgd" (momentum picks sgd_mom), "adam", or
    # None for the generic path through update(). The optimizers that set
    # it read their lr through _op_lr, which is what a grouped step needs.
    fused_slab_kernel = None

    def create_state(self, index, weight):
        return None

    def create_state_flat(self, index, size, dtype="float32", ctx=None):
        """State for a flat slab of ``size`` elements on ``ctx``: the
        regular create_state on a flat zeros weight (valid for every
        elementwise_update optimizer)."""
        assert self.elementwise_update, (
            "%s cannot create flat state (elementwise_update is False)" % type(self).__name__)
        return self.create_state(index, nd.zeros((size,), ctx=ctx, dtype=dtype))

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def set_lr_scale(self, args_lrscale):  # deprecated reference API
        raise DeprecationWarning


register = Optimizer.register


def _zeros_like_weight(weight, dtype=None):
    return nd.zeros(weight.shape, ctx=weight.context, dtype=dtype or weight.dtype)


@register
class SGD(Optimizer):
    """SGD with momentum through the fused sgd_update / sgd_mom_update."""

    elementwise_update = True
    fused_slab_kernel = "sgd"

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros_like_weight(weight) if self.momentum else None

    def update(self, index, weight, grad, state):
        kwargs = self._fused_kwargs(index)
        kwargs["lr"] = self._op_lr(index, kwargs["lr"])
        if state is None:
            nd.sgd_update(weight, grad, out=weight, **kwargs)
        else:
            nd.sgd_mom_update(weight, grad, state, out=weight, momentum=self.momentum, **kwargs)


@register
class NAG(SGD):
    """Nesterov accelerated SGD."""

    fused_slab_kernel = None  # no Nesterov variant of K1

    def update(self, index, weight, grad, state):
        lr, wd, g = self._begin_update(index, grad)
        if state is None:
            weight[:] = weight - lr * (g + wd * weight)
            return
        state[:] = self.momentum * state + g + wd * weight
        weight[:] = weight - lr * (g + wd * weight + self.momentum * state)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: a half step of SGD plus
    gaussian exploration noise of standard deviation sqrt(lr).

    The noise comes from the optimizer's own ``torch.Generator`` on the
    weight's device, seeded from ``mx.random``'s seed and seeded again
    whenever ``mx.random.seed`` (or ``set_states``) is called, so a seed
    repeats a run; with no seed set it is seeded from the operating system's
    entropy, leaving numpy's global stream alone. The JAX package draws it
    from threefry keys, which torch's generators cannot reproduce: the draws
    are held to it by their moments."""

    elementwise_update = False  # one draw of the weight's shape an update

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._generators = {}  # device -> (the seeding it was made for, generator)

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_generators"] = {}  # a generator does not pickle; a copy seeds its own
        return state

    def _generator(self, device):
        st = _random._st()
        seeding = (st.seed, st.seedings)
        made = self._generators.get(device)
        if made is None or made[0] != seeding:
            gen = torch.Generator(device=device)
            if st.seed is None:
                gen.seed()
            else:
                gen.manual_seed(st.seed ^ 0x5D1D)  # a stream apart from the samplers'
            made = self._generators[device] = (seeding, gen)
        return made[1]

    def update(self, index, weight, grad, state):
        lr, wd, g = self._begin_update(index, grad)
        w = weight._data
        noise = torch.randn(w.shape, generator=self._generator(w.device), dtype=torch.float32,
                            device=w.device) * (lr ** 0.5)
        weight[:] = weight - (lr / 2) * (g + wd * weight) + nd.NDArray(noise.to(w.dtype))


@register
class ccSGD(SGD):
    """The reference's alias of SGD, with the same math."""


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD: corrects stale gradients with
    lamda * g^2 * (w - w_at_gradient_time)."""

    elementwise_update = False  # create_state snapshots the live weights

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = _zeros_like_weight(weight) if self.momentum else None
        return (mom, weight.copy())

    def update(self, index, weight, grad, state):
        lr, wd, g = self._begin_update(index, grad)
        mom, stale_weight = state
        compensated = g + wd * weight + self.lamda * g * g * (weight - stale_weight)
        if mom is not None:
            mom[:] = self.momentum * mom - lr * compensated
            step = mom
        else:
            step = -lr * compensated
        stale_weight[:] = weight
        weight[:] = weight + step


@register
class Adam(Optimizer):
    """Adam through the fused adam_update, bias correction folded into lr."""

    elementwise_update = True
    fused_slab_kernel = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like_weight(weight), _zeros_like_weight(weight))

    def bias_fix(self, t):
        """The factor Adam's lr takes at update count ``t``."""
        return (1.0 - self.beta2 ** t) ** 0.5 / (1.0 - self.beta1 ** t)

    def fused_lr(self, index, lr):
        return lr * self.bias_fix(self._index_update_count[index])

    def update(self, index, weight, grad, state):
        kwargs = self._fused_kwargs(index)
        kwargs["lr"] = self._op_lr(index, kwargs["lr"])
        mean, var = state
        nd.adam_update(weight, grad, mean, var, out=weight, beta1=self.beta1,
                       beta2=self.beta2, epsilon=self.epsilon, **kwargs)


@register
class AdaGrad(Optimizer):
    """Accumulated squared-gradient scaling (Duchi et al.)."""

    elementwise_update = True

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like_weight(weight, dtype="float32")

    def update(self, index, weight, grad, state):
        lr, wd, g = self._begin_update(index, grad)
        state += g * g
        weight[:] = weight - lr * (g / nd.sqrt(state + self.float_stable_eps) + wd * weight)


@register
class RMSProp(Optimizer):
    """RMSProp (Tieleman/Hinton; Graves when centered) through the fused
    rmsprop_update / rmspropalex_update."""

    elementwise_update = True

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9, epsilon=1e-8,
                 centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n_slots = 3 if self.centered else 1
        return tuple(_zeros_like_weight(weight, dtype="float32") for _ in range(n_slots))

    def update(self, index, weight, grad, state):
        kwargs = self._fused_kwargs(index)
        kwargs.update(gamma1=self.gamma1, epsilon=self.epsilon,
                      clip_weights=self.clip_weights or -1.0)
        if self.centered:
            n, g, delta = state
            nd.rmspropalex_update(weight, grad, n, g, delta, out=weight, gamma2=self.gamma2,
                                  **kwargs)
        else:
            nd.rmsprop_update(weight, grad, state[0], out=weight, **kwargs)


@register
class AdaDelta(Optimizer):
    """Adadelta (Zeiler): unit-correcting accumulated deltas, no lr."""

    elementwise_update = True

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like_weight(weight, dtype="float32"),
                _zeros_like_weight(weight, dtype="float32"))

    def update(self, index, weight, grad, state):
        _lr, wd, g = self._begin_update(index, grad)
        acc_g, acc_delta = state
        acc_g[:] = self.rho * acc_g + (1.0 - self.rho) * g * g
        delta = nd.sqrt(acc_delta + self.epsilon) / nd.sqrt(acc_g + self.epsilon) * g
        acc_delta[:] = self.rho * acc_delta + (1.0 - self.rho) * delta * delta
        weight[:] = weight - delta - wd * weight


@register
class Ftrl(Optimizer):
    """FTRL-proximal (McMahan et al.) with L1 shrinkage ``lamda1``."""

    elementwise_update = True

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like_weight(weight, dtype="float32"),   # z
                _zeros_like_weight(weight, dtype="float32"))   # sum g^2

    def update(self, index, weight, grad, state):
        # the reference's order, kept for the lr trajectory: Ftrl alone
        # moves the update count BEFORE resolving the scheduled lr
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._condition_grad(grad)
        z, n = state
        z += g - (nd.sqrt(n + g * g) - nd.sqrt(n)) * weight / lr
        n += g * g
        weight[:] = (nd.sign(z) * self.lamda1 - z) * (nd.abs(z) > self.lamda1) \
            / ((self.beta + nd.sqrt(n)) / lr + wd)


@register
class Test(Optimizer):
    """weight += rescale_grad * grad, state mirrors the weight: the
    reference's dist kvstore test optimizer."""

    elementwise_update = True

    def create_state(self, index, weight):
        return _zeros_like_weight(weight)

    def update(self, index, weight, grad, state):
        weight += grad * self.rescale_grad
        state[:] = weight


create = Optimizer.create_optimizer


def _state_leaf(state):
    """The first NDArray of a state tree, or None."""
    if isinstance(state, (tuple, list)):
        for s in state:
            leaf = _state_leaf(s)
            if leaf is not None:
                return leaf
        return None
    return state if isinstance(state, nd.NDArray) else None


def _state_to(state, ctx):
    if isinstance(state, (tuple, list)):
        return type(state)(_state_to(s, ctx) for s in state)
    return state.as_in_context(ctx) if isinstance(state, nd.NDArray) else state


class Updater:
    """Applies one optimizer across parameters keyed by index, creating
    state lazily; its pickled states are the optimizer checkpoint. A state
    that lies on another device than its weight (unpickled states land on
    the host) moves to the weight's device at its first update."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        state = self.states[index]
        leaf = _state_leaf(state)
        if leaf is not None and leaf.context != weight.context:
            self.states[index] = state = _state_to(state, weight.context)
        self.optimizer.update(index, weight, grad, state)

    def set_states(self, states):
        self.states = pickle.loads(states)

    def get_states(self):
        return pickle.dumps(self.states)


def get_updater(optimizer):
    return Updater(optimizer)
