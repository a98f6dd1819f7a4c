"""Symbolic RNN cells of the PyTorch port (counterpart of
``mxnet_tpu/rnn/rnn_cell.py``): RNNCell, LSTMCell, GRUCell, FusedRNNCell
(the fused ``RNN`` operator, ``ops/rnn_op.py``: cuDNN on the card),
SequentialRNNCell, BidirectionalCell, DropoutCell, ZoneoutCell,
ResidualCell and ModifierCell, the unroll helpers, and the cuDNN-layout
pack / unpack of a fused blob, so weights cross between the fused and the
unfused cells and between the two packages' checkpoints.

The cells build the same symbols, under the same names, as the JAX
package's. Weights a cell unpacks or packs stay on the context of the
arrays it was given.
"""
from __future__ import annotations

import numpy as np

from .. import ndarray as nd
from .. import symbol


def _ctx_of(arr):
    """The context of an NDArray (None, the current one, for numpy)."""
    return arr.context if isinstance(arr, nd.NDArray) else None


class RNNParams(object):
    """Container holding a cell's parameter symbols."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract RNN cell (reference rnn_cell.py:60)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError()

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified, (
            "After applying modifier cells the base cell cannot be called "
            "directly. Call the modifier cell instead."
        )
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is None:
                state = func(
                    name="%sbegin_state_%d" % (self._prefix, self._init_counter),
                    **kwargs
                )
            else:
                kwargs.update(info)
                state = func(
                    name="%sbegin_state_%d" % (self._prefix, self._init_counter),
                    **kwargs
                )
            states.append(state)
        return states

    def unpack_weights(self, args):
        """fused-blob ↔ per-gate dict (reference rnn_cell.py:143)."""
        args = args.copy()
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = weight[j * h : (j + 1) * h].copy()
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = bias[j * h : (j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        args = args.copy()
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                weight.append(args.pop(wname))
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                bias.append(args.pop(bname))
            args["%s%s_weight" % (self._prefix, group_name)] = nd.concatenate(weight)
            args["%s%s_bias" % (self._prefix, group_name)] = nd.concatenate(bias)
        return args

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=False):
        """Unroll the cell over `length` steps (reference rnn_cell.py:205)."""
        self.reset()
        if inputs is None:
            inputs = [
                symbol.Variable("%st%d_data" % (input_prefix, i))
                for i in range(length)
            ]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1, (
                "unroll doesn't allow grouped symbol as input. Please "
                "convert to list first or let unroll handle slicing"
            )
            axis = layout.find("T")
            inputs = symbol.SliceChannel(
                inputs, axis=axis, num_outputs=length, squeeze_axis=1
            )
        else:
            assert len(inputs) == length
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=1) for i in outputs]
            outputs = symbol.Concat(*outputs, dim=1)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell (reference rnn_cell.py:317)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=self._num_hidden, name="%si2h" % name
        )
        h2h = symbol.FullyConnected(
            data=states[0], weight=self._hW, bias=self._hB,
            num_hidden=self._num_hidden, name="%sh2h" % name
        )
        output = self._get_activation(
            i2h + h2h, self._activation, name="%sout" % name
        )
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference rnn_cell.py:365); gate order i,f,g(c),o matches
    the fused kernel so pack/unpack round-trips."""

    def __init__(self, num_hidden, prefix="lstm_", params=None, forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        from ..initializer import LSTMBias

        self._iB = self.params.get(
            "i2h_bias", init=LSTMBias(forget_bias=forget_bias)
        )
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [
            {"shape": (0, self._num_hidden), "__layout__": "NC"},
            {"shape": (0, self._num_hidden), "__layout__": "NC"},
        ]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=self._num_hidden * 4, name="%si2h" % name
        )
        h2h = symbol.FullyConnected(
            data=states[0], weight=self._hW, bias=self._hB,
            num_hidden=self._num_hidden * 4, name="%sh2h" % name
        )
        gates = i2h + h2h
        slice_gates = symbol.SliceChannel(
            gates, num_outputs=4, name="%sslice" % name
        )
        in_gate = symbol.Activation(
            slice_gates[0], act_type="sigmoid", name="%si" % name
        )
        forget_gate = symbol.Activation(
            slice_gates[1], act_type="sigmoid", name="%sf" % name
        )
        in_transform = symbol.Activation(
            slice_gates[2], act_type="tanh", name="%sc" % name
        )
        out_gate = symbol.Activation(
            slice_gates[3], act_type="sigmoid", name="%so" % name
        )
        next_c = symbol._plus(
            forget_gate * states[1], in_gate * in_transform,
            name="%sstate" % name
        )
        next_h = symbol._mul(
            out_gate, symbol.Activation(next_c, act_type="tanh"),
            name="%sout" % name
        )
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference rnn_cell.py:428); gate order r,z,n (cuDNN)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        seq_idx = self._counter
        name = "%st%d_" % (self._prefix, seq_idx)
        prev_state_h = states[0]
        i2h = symbol.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=self._num_hidden * 3, name="%s_i2h" % name
        )
        h2h = symbol.FullyConnected(
            data=prev_state_h, weight=self._hW, bias=self._hB,
            num_hidden=self._num_hidden * 3, name="%s_h2h" % name
        )
        i2h_r, i2h_z, i2h = symbol.SliceChannel(
            i2h, num_outputs=3, name="%s_i2h_slice" % name
        )
        h2h_r, h2h_z, h2h = symbol.SliceChannel(
            h2h, num_outputs=3, name="%s_h2h_slice" % name
        )
        reset_gate = symbol.Activation(
            i2h_r + h2h_r, act_type="sigmoid", name="%s_r_act" % name
        )
        update_gate = symbol.Activation(
            i2h_z + h2h_z, act_type="sigmoid", name="%s_z_act" % name
        )
        next_h_tmp = symbol.Activation(
            i2h + reset_gate * h2h, act_type="tanh", name="%s_h_act" % name
        )
        next_h = symbol._plus(
            (1.0 - update_gate) * next_h_tmp, update_gate * prev_state_h,
            name="%sout" % name
        )
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN via the RNN op (reference rnn_cell.py:497)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        from ..initializer import FusedRNN as FusedRNNInit, Xavier

        self._parameter = self.params.get(
            "parameters",
            init=FusedRNNInit(
                Xavier(factor_type="in", magnitude=2.34), num_hidden,
                num_layers, mode, bidirectional, forget_bias
            ),
        )

    @property
    def state_info(self):
        b = self._bidirectional + 1
        n = (self._mode == "lstm") + 1
        return [
            {
                "shape": (b * self._num_layers, 0, self._num_hidden),
                "__layout__": "LNC",
            }
            for _ in range(n)
        ]

    @property
    def _gate_names(self):
        return {
            "rnn_relu": [""],
            "rnn_tanh": [""],
            "lstm": ["_i", "_f", "_c", "_o"],
            "gru": ["_r", "_z", "_o"],
        }[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _slice_weights(self, arr, li, lh):
        """Slice the packed blob into per-layer/gate views (reference
        rnn_cell.py:550)."""
        args = {}
        gate_names = self._gate_names
        directions = self._directions
        b = len(directions)
        p = 0
        for layer in range(self._num_layers):
            for direction in directions:
                for gate in gate_names:
                    name = "%s%s%d_i2h%s_weight" % (
                        self._prefix, direction, layer, gate
                    )
                    if layer > 0:
                        size = b * lh * lh
                        args[name] = arr[p : p + size].reshape((lh, b * lh))
                    else:
                        size = li * lh
                        args[name] = arr[p : p + size].reshape((lh, li))
                    p += size
                for gate in gate_names:
                    name = "%s%s%d_h2h%s_weight" % (
                        self._prefix, direction, layer, gate
                    )
                    size = lh ** 2
                    args[name] = arr[p : p + size].reshape((lh, lh))
                    p += size
        for layer in range(self._num_layers):
            for direction in directions:
                for gate in gate_names:
                    name = "%s%s%d_i2h%s_bias" % (
                        self._prefix, direction, layer, gate
                    )
                    args[name] = arr[p : p + lh]
                    p += lh
                for gate in gate_names:
                    name = "%s%s%d_h2h%s_bias" % (
                        self._prefix, direction, layer, gate
                    )
                    args[name] = arr[p : p + lh]
                    p += lh
        assert p == arr.size, "Invalid parameters size for FusedRNNCell"
        return args

    def unpack_weights(self, args):
        args = args.copy()
        arr = args.pop(self._parameter.name)
        b = len(self._directions)
        m = self._num_gates
        h = self._num_hidden
        num_input = int(arr.size / b / h / m - (self._num_layers - 1) * (h + b * h + 2) - h - 2)
        host = arr.asnumpy() if isinstance(arr, nd.NDArray) else np.asarray(arr)
        nargs = self._slice_weights(host, num_input, self._num_hidden)
        args.update({name: nd.array(mat, ctx=_ctx_of(arr)) for name, mat in nargs.items()})
        return args

    def pack_weights(self, args):
        # NDArray slices are copies (functional buffers), so assemble the
        # blob by concatenating parts in _slice_weights traversal order.
        args = args.copy()
        w0 = args["%sl0_i2h%s_weight" % (self._prefix, self._gate_names[0])]
        num_input = w0.shape[1]
        total = self._get_param_size(num_input)
        template = np.zeros((total,), np.float32)  # only its slices' shapes are read
        parts = []
        for name, tensor in self._slice_weights(
            template, num_input, self._num_hidden
        ).items():
            val = args.pop(name)
            val = val.asnumpy() if isinstance(val, nd.NDArray) else np.asarray(val)
            assert tuple(val.shape) == tuple(tensor.shape), (
                "pack_weights: %s shape %s != expected %s"
                % (name, val.shape, tensor.shape)
            )
            parts.append(val.reshape(-1))
        args[self._parameter.name] = nd.array(np.concatenate(parts), ctx=_ctx_of(w0))
        return args

    def _get_param_size(self, num_input):
        from ..ops.rnn_op import _rnn_param_size

        return _rnn_param_size(
            self._num_layers, num_input, self._num_hidden,
            self._bidirectional, self._mode
        )

    def __call__(self, inputs, states):
        raise NotImplementedError("FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=True):
        self.reset()
        assert layout in ("NTC", "TNC"), "unknown layout %s" % layout
        if inputs is None:
            inputs = symbol.Variable("%sdata" % input_prefix)
        if isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1
            if layout == "NTC":
                inputs = symbol.SwapAxis(inputs, dim1=0, dim2=1)
        else:
            assert len(inputs) == length
            inputs = [symbol.expand_dims(i, axis=0) for i in inputs]
            inputs = symbol.Concat(*inputs, dim=0)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        if self._mode == "lstm":
            states = {"state": states[0], "state_cell": states[1]}
        else:
            states = {"state": states[0]}
        rnn = symbol.RNN(
            data=inputs, parameters=self._parameter,
            state_size=self._num_hidden, num_layers=self._num_layers,
            bidirectional=self._bidirectional, p=self._dropout,
            state_outputs=self._get_next_state, mode=self._mode,
            name=self._prefix + "rnn", **states
        )
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if layout == "NTC":
            outputs = symbol.SwapAxis(outputs, dim1=0, dim2=1)
        if not merge_outputs:
            outputs = symbol.SliceChannel(
                outputs, axis=layout.find("T"), num_outputs=length,
                squeeze_axis=1
            )
            outputs = list(outputs)
        return outputs, states

    def unfuse(self):
        """Return an unfused SequentialRNNCell computing the same thing
        (reference rnn_cell.py:659)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda cell_prefix: RNNCell(
                self._num_hidden, activation="relu", prefix=cell_prefix
            ),
            "rnn_tanh": lambda cell_prefix: RNNCell(
                self._num_hidden, activation="tanh", prefix=cell_prefix
            ),
            "lstm": lambda cell_prefix: LSTMCell(
                self._num_hidden, prefix=cell_prefix
            ),
            "gru": lambda cell_prefix: GRUCell(
                self._num_hidden, prefix=cell_prefix
            ),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(
                    BidirectionalCell(
                        get_cell("%sl%d_" % (self._prefix, i)),
                        get_cell("%sr%d_" % (self._prefix, i)),
                        output_prefix="%sbi_%s_%d" % (self._prefix, self._mode, i),
                    )
                )
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(
                    self._dropout, prefix="%s_dropout%d_" % (self._prefix, i)
                ))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack of cells (reference rnn_cell.py:685)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params, (
                "Either specify params for SequentialRNNCell or child cells, "
                "not both."
            )
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info)
            state = states[p : p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=False):
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state()
        num_cells = len(self._cells)
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p : p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, input_prefix=input_prefix,
                begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs,
            )
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout between steps (reference rnn_cell.py:763)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference rnn_cell.py:793)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, init_sym=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(init_sym, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (reference rnn_cell.py:839)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, FusedRNNCell), (
            "FusedRNNCell doesn't support zoneout. Please unfuse first."
        )
        assert not isinstance(base_cell, BidirectionalCell), (
            "BidirectionalCell doesn't support zoneout since it doesn't "
            "support step. Please add ZoneoutCell to the cells underneath "
            "instead."
        )
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (
            self.base_cell, self.zoneout_outputs, self.zoneout_states
        )
        next_output, next_states = cell(inputs, states)
        mask = lambda p, like: symbol.Dropout(
            symbol.ones_like(like), p=p
        )
        prev_output = self.prev_output if self.prev_output is not None else (
            symbol.zeros_like(next_output)
        )
        output = (
            symbol.where(mask(p_outputs, next_output), next_output, prev_output)
            if p_outputs != 0.0
            else next_output
        )
        states = (
            [
                symbol.where(mask(p_states, new_s), new_s, old_s)
                for new_s, old_s in zip(next_states, states)
            ]
            if p_states != 0.0
            else next_states
        )
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """Residual connection around a cell."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol._plus(output, inputs, name="%s_plus_residual" % output.name)
        return output, states


class BidirectionalCell(BaseRNNCell):
    """Bidirectional wrapper (reference rnn_cell.py:881)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unroll(self, length, inputs=None, begin_state=None, input_prefix="",
               layout="NTC", merge_outputs=False):
        self.reset()
        if inputs is None:
            inputs = [
                symbol.Variable("%st%d_data" % (input_prefix, i))
                for i in range(length)
            ]
        elif isinstance(inputs, symbol.Symbol):
            assert len(inputs.list_outputs()) == 1
            axis = layout.find("T")
            inputs = list(symbol.SliceChannel(
                inputs, axis=axis, num_outputs=length, squeeze_axis=1
            ))
        else:
            assert len(inputs) == length
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        l_cell, r_cell = self._cells
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[: len(l_cell.state_info)],
            layout=layout, merge_outputs=False
        )
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info):],
            layout=layout, merge_outputs=False
        )
        outputs = [
            symbol.Concat(
                l_o, r_o, dim=1,
                name="%st%d" % (self._output_prefix, i)
            )
            for i, (l_o, r_o) in enumerate(zip(l_outputs, reversed(r_outputs)))
        ]
        if merge_outputs:
            outputs = [symbol.expand_dims(i, axis=1) for i in outputs]
            outputs = symbol.Concat(
                *outputs, dim=1, name="%sout" % self._output_prefix
            )
        states = [l_states, r_states]
        return outputs, states


def _cells_state_info(cells):
    return sum([c.state_info for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args
