"""Contrib operators of the port (counterpart of
``mxnet_tpu/contrib/ops.py``). Registered so far: ``_contrib_SwitchMoE``
(alias ``SwitchMoE``), the Switch-MoE FFN of ``parallel.moe`` as a Symbol
operator. The file's other operators (MultiBox*, Proposal, ROIPooling,
CTCLoss, fft / ifft, quantize / dequantize, count_sketch) are not ported
yet: ``CONTRIB_OP_EXPORTS`` keeps the JAX package's full list, and the
namespaces expose only what is registered.
"""
from __future__ import annotations

from ..base import MXNetError
from ..ops.registry import OpDef, register


def _switch_moe(attrs, ins, is_train):
    """Two outputs: the routed FFN's result [tokens, d_model] and the
    load-balance aux loss as a [1] tensor (add it to the objective through
    MakeLoss)."""
    from ..parallel.moe import switch_moe

    data, gate_w, w_up, w_down = ins
    y, aux = switch_moe({"gate_w": gate_w, "w_up": w_up, "w_down": w_down}, data,
                        capacity_factor=float(attrs.get("capacity_factor", 1.25)))
    return [y, aux.reshape(1)]


def _switch_moe_infer(attrs, in_shapes):
    data, _, _, _ = in_shapes
    if data is None:
        raise MXNetError("SwitchMoE: data shape required")  # resolvable later
    if len(data) != 2:
        # ValueError: a known but wrong rank must survive the inference
        # fixpoint loop, which takes MXNetError as "not resolvable yet"
        raise ValueError("SwitchMoE: data must be [tokens, d_model] "
                         "(Reshape (B,T,D) inputs to (B*T, D))")
    d_model = data[1]
    num_experts = int(attrs["num_experts"])
    d_hidden = int(attrs["num_hidden"])
    if d_hidden <= 0:
        # a 0 width would infer empty expert weights and train the MoE
        # branch as a no-op
        raise ValueError("SwitchMoE: num_hidden must be set (> 0)")
    return (
        [tuple(data), (d_model, num_experts),
         (num_experts, d_model, d_hidden), (num_experts, d_hidden, d_model)],
        [tuple(data), (1,)],
        [],
    )


register(
    OpDef(
        "_contrib_SwitchMoE",
        _switch_moe,
        arguments=("data", "gate_weight", "up_weight", "down_weight"),
        outputs=("output", "aux_loss"),
        defaults={"num_experts": 8, "num_hidden": 0, "capacity_factor": 1.25},
        infer_shape=_switch_moe_infer,
        aliases=("SwitchMoE",),
    )
)


# The names contrib/{symbol,ndarray}.py expose where registered, the JAX
# package's list
CONTRIB_OP_EXPORTS = (
    "MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection", "Proposal",
    "ROIPooling", "CTCLoss", "ctc_loss", "fft", "ifft", "quantize",
    "dequantize", "count_sketch", "SwitchMoE",
)
