"""Transformer LM of the PyTorch port (counterpart of
``mxnet_tpu/models/transformer.py``): the dense model, its Switch-MoE
variant, and the dense model's KV-cached serving twin.

Parameters come from the JAX package's param tree
(``{"embed", "l{i}": {ln1, ln2, wq, wk, wv, wo, w1, w2}, "ln_f"}``; a MoE
layer has ``moe: {gate_w, w_up, w_down}`` in place of ``w1``/``w2``) through
:func:`params_from_jax`, which stores projection weights as ``nn.Linear``
does ([out, in], the transpose of the tree's [in, out]), the MoE tensors in
the tree's expert-major layout, and keeps the embedding and the router
``gate_w`` in f32, because the LM head multiplies against the f32 table and
the router computes in f32.
``transformer_lm(...)[0]`` makes that tree with the same numpy
``RandomState`` draws as the JAX package, so ``init_fn(0)`` is bit-identical
in both. :func:`params_to_jax` and :func:`grads_to_jax` carry parameters and
their gradients back into that tree's layout.

Training: ``apply_fn`` is differentiable. Parameters made with
``dtype=torch.float32`` and ``.requires_grad_()`` are f32 masters; each use
casts to the compute dtype, as ``p["wq"].astype(dtype)`` does in JAX, so
the gradients reach the masters in f32.

Rounding sits where the JAX package puts it: rmsnorm in f32 and cast back;
embedding and positional table each cast to the compute dtype before the
add; logits as ``x.float() @ embed.T`` against the f32 table.

Tensor parallelism (Megatron's layout, as the JAX trainer's ``spec_for``
gives it: :func:`partition_spec`): over a mesh whose tp axis is t, tp rank
r holds columns ``[r·H/t, (r+1)·H/t)`` of ``wq``, ``wk``, ``wv`` (its H/t
heads) and of ``w1``, and the matching rows of ``wo`` and ``w2``; the
embedding, the gains and the head stay replicated. :func:`shard_params`
cuts a whole set of parameters into this process's shards and
:func:`gather_params` puts them back together. ``apply_fn`` over such a
mesh runs each of this process's tp ranks on its heads (attention through
``ops.kernels.attention``: K4f forward, K4dq / K4dkv backward) and its FFN
columns, sums the ranks' row-parallel products on the device, and sums
those over the tp axis's processes (Megatron's *g*; the block input enters
through *f*, so its gradient is summed backward). The partial products are
summed in the compute dtype (in bf16, for tp = 2 one rounding of their
exact sum, which is what an f32 sum rounded to bf16 gives). A mesh whose sp
axis spans processes takes this process's block of the sequence (its
positional rows by the block's offset; attention across the processes,
``parallel/ring_attention.py``); a MoE layer then routes the whole
sequence, gathered over sp, and keeps its block. An ep axis that spans
processes runs each process's experts (``parallel/moe.py``).

Serving: the JAX version donates the cache to a jitted step. Here the
cache tensors are preallocated once and prefill/decode write into them in
place (advanced-index assignment), returning the same dict. A prefill
whose slot vector is padded with the engine's scratch row writes that row
several times; which write lands is undefined on CUDA, but only the
scratch row is affected, and a live slot never repeats.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..context import resolve_device
from ..ops import kernels as _kernels
from ..parallel import mesh as _mesh
from ..parallel.moe import init_moe_params, moe_partition_specs, switch_moe
from ..parallel.ring_attention import gather_sequence

_NEG_INF = -1e30


def _torch_dtype(dtype):
    if dtype is None:
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(dtype)]


def _host_array(a):
    """A tree leaf as a numpy array torch can take (bf16 leaves widen to
    f32 exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def _param(a, device, dtype, transpose=False):
    a = _host_array(a)
    if transpose:
        a = np.ascontiguousarray(a.T)
    t = torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)
    return nn.Parameter(t, requires_grad=False)


_MOE_NAMES = ("gate_w", "w_up", "w_down")


class TransformerLayer(nn.Module):
    """One pre-norm block's weights: rmsnorm gains ``ln1``/``ln2``, the
    projections ``wq wk wv wo`` stored [out, in], and either the FFN's
    ``w1 w2`` ([out, in]) or, in a MoE layer, ``moe``: a ParameterDict of
    ``gate_w`` [d_model, E] (f32), ``w_up`` [E, d_model, d_ff] and
    ``w_down`` [E, d_ff, d_model]."""

    def __init__(self, tree, device, dtype):
        super().__init__()
        self.ln1 = _param(tree["ln1"], device, dtype)
        self.ln2 = _param(tree["ln2"], device, dtype)
        ffn = ("w1", "w2") if "moe" not in tree else ()
        for name in ("wq", "wk", "wv", "wo") + ffn:
            setattr(self, name, _param(tree[name], device, dtype, transpose=True))
        self.moe = None
        if "moe" in tree:
            self.moe = nn.ParameterDict({
                name: _param(tree["moe"][name], device,
                             torch.float32 if name == "gate_w" else dtype)
                for name in _MOE_NAMES})


class TransformerParams(nn.Module):
    """The port's parameters: f32 ``embed`` [vocab, d_model], ``layers``,
    and the final rmsnorm gain ``ln_f``."""

    def __init__(self, tree, device, dtype):
        super().__init__()
        n_layers = sum(1 for key in tree if key.startswith("l") and key[1:].isdigit())
        self.embed = _param(tree["embed"], device, torch.float32)
        self.layers = nn.ModuleList(
            TransformerLayer(tree["l%d" % i], device, dtype) for i in range(n_layers))
        self.ln_f = _param(tree["ln_f"], device, dtype)

    @property
    def device(self):
        return self.embed.device


def params_from_jax(tree, device=None, dtype=None):
    """The JAX param tree (numpy or ``np.asarray``-able leaves) as the
    port's :class:`TransformerParams` on ``device`` (default: the CUDA
    card), projections and gains in ``dtype`` (default bf16), the
    embedding in f32."""
    return TransformerParams(tree, resolve_device(device), _torch_dtype(dtype))


def _tree(params, leaf):
    """The JAX param tree of ``params`` with ``leaf(tensor)`` at each leaf
    (numpy f32); projections transposed back to [in, out]."""
    def host(x, transpose=False):
        a = leaf(x).detach().float().cpu().numpy()
        return np.ascontiguousarray(a.T) if transpose else a

    tree = {"embed": host(params.embed), "ln_f": host(params.ln_f)}
    for i, layer in enumerate(params.layers):
        node = tree["l%d" % i] = {"ln1": host(layer.ln1), "ln2": host(layer.ln2)}
        ffn = ("w1", "w2") if layer.moe is None else ()
        for name in ("wq", "wk", "wv", "wo") + ffn:
            node[name] = host(getattr(layer, name), transpose=True)
        if layer.moe is not None:
            node["moe"] = {name: host(layer.moe[name]) for name in _MOE_NAMES}
    return tree


def params_to_jax(params):
    """The inverse of :func:`params_from_jax`: the parameters as the JAX
    package's numpy param tree (f32 leaves, projections [in, out])."""
    return _tree(params, lambda p: p)


def grads_to_jax(params):
    """The parameters' ``.grad`` as a tree in the JAX layout of
    :func:`params_to_jax`; raises if a parameter has no gradient."""
    def grad(p):
        if p.grad is None:
            raise ValueError("a parameter has no gradient; run backward first")
        return p.grad

    return _tree(params, grad)


def partition_spec(path):
    """The JAX trainer's ``spec_for`` of the tree leaf at ``path`` (e.g.
    ``"l0/wq"``, ``"l1/moe/w_up"``) as a tuple of axis names and None, in
    the tree's [in, out] layout: Megatron's column-parallel ``wq wk wv w1``
    ``(None, "tp")``, row-parallel ``wo w2`` ``("tp", None)``, the experts
    ``("ep", None, None)``, everything else replicated ``()``."""
    parts = path.split("/")
    if "moe" in parts:
        return moe_partition_specs()[parts[-1]]
    if parts[-1] in ("wq", "wk", "wv", "w1"):
        return (None, "tp")
    if parts[-1] in ("wo", "w2"):
        return ("tp", None)
    return ()


def _sharded_leaves(params):
    """(owner module or ParameterDict, attribute, axis, dim of the port's
    storage) of every parameter a mesh axis shards."""
    out = []
    for i, layer in enumerate(params.layers):
        ffn = ("w1", "w2") if layer.moe is None else ()
        for name in ("wq", "wk", "wv", "wo") + ffn:
            spec = partition_spec("l%d/%s" % (i, name))
            dim = next(d for d, ax in enumerate(spec) if ax is not None)
            out.append((layer, name, spec[dim], 1 - dim))  # stored [out, in]
        if layer.moe is not None:
            for name in ("w_up", "w_down"):
                out.append((layer.moe, name, partition_spec("l%d/moe/%s" % (i, name))[0], 0))
    return out


def _get(owner, name):
    return owner[name] if isinstance(owner, nn.ParameterDict) else getattr(owner, name)


def _set(owner, name, value):
    if isinstance(owner, nn.ParameterDict):
        owner[name] = value
    else:
        setattr(owner, name, value)


def shard_params(params, mesh):
    """A copy of the whole ``params`` (e.g. from :func:`params_from_jax`)
    holding only this process's shards on ``mesh``: of each tp-sharded
    projection the slice of this process's tp positions, of the experts
    those of its ep positions (:func:`partition_spec`); replicated leaves
    whole. On a mesh of one process every position is local, so the copy
    is whole."""
    out = copy.deepcopy(params)
    for owner, name, axis, dim in _sharded_leaves(out):
        p = _get(owner, name)
        n = _mesh.axis_size(mesh, axis)
        if n == 1:
            continue
        if p.shape[dim] % n:
            raise ValueError("%s (%s) does not split into %s = %d shards"
                             % (name, tuple(p.shape), axis, n))
        pos = _mesh.axis_group(mesh, axis).positions
        per = p.shape[dim] // n
        piece = p.detach().narrow(dim, pos[0] * per, len(pos) * per).contiguous()
        _set(owner, name, nn.Parameter(piece, requires_grad=p.requires_grad))
    return out


def gather_params(params, mesh):
    """The inverse of :func:`shard_params`: a copy of this process's shards
    with each sharded leaf gathered whole from the processes of its axis (a
    collective: every process calls it at the same point)."""
    out = copy.deepcopy(params)
    for owner, name, axis, dim in _sharded_leaves(out):
        grp = _mesh.axis_group(mesh, axis) if _mesh.axis_size(mesh, axis) > 1 else None
        if grp is None or grp.size <= 1:
            continue
        p = _get(owner, name).detach()
        whole = _mesh.all_gather(p.transpose(0, dim).contiguous(), axis=grp).transpose(0, dim)
        _set(owner, name, nn.Parameter(whole.contiguous(), requires_grad=False))
    return out


def replicated_names(params):
    """The names (``named_parameters``) of the parameters no mesh axis
    shards: every tp and ep rank holds them whole."""
    sharded = {id(_get(owner, name)) for owner, name, _, _ in _sharded_leaves(params)}
    return [n for n, p in params.named_parameters() if id(p) not in sharded]


def _axis_groups(mesh):
    """axis -> AxisGroup where ``mesh`` spans processes on that axis, else
    None; the tp entry also for logical tp ranks of one process."""
    groups = dict.fromkeys(_mesh.AXES)
    if mesh is None:
        return groups
    spans = getattr(mesh, "processes", 1) > 1
    for axis in ("tp", "sp", "ep"):
        if _mesh.axis_size(mesh, axis) > 1 and (spans or axis == "tp"):
            groups[axis] = _mesh.axis_group(mesh, axis)
    return groups


def _sinusoid_pe(n_rows, d_model):
    pos = np.arange(n_rows)[:, None] / (
        10000 ** (np.arange(0, d_model, 2) / d_model)
    )
    return np.concatenate([np.sin(pos), np.cos(pos)], axis=-1)


def _rmsnorm(x, g):
    x32 = x.float()
    n = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + 1e-6)
    return (n * g).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _ffn(x, layer, dtype):
    h = _rmsnorm(x, layer.ln2.to(dtype))
    h = _gelu(F.linear(h, layer.w1.to(dtype)))
    return x + F.linear(h, layer.w2.to(dtype))


def _qkv(h, layer, dtype, shape):
    return tuple(F.linear(h, w.to(dtype)).reshape(shape)
                 for w in (layer.wq, layer.wk, layer.wv))


def dense_block(x, layer, n_heads, dtype, mesh=None):
    """One dense pre-norm block on one rank, ``apply_fn``'s ops for a layer
    without tp or MoE: attention through ``kernels.attention`` (the flash
    kernels on the card), then the FFN. ``layer`` has the
    :class:`TransformerLayer` names (``ln1 ln2 wq wk wv wo w1 w2``), as
    attributes; the pipeline's stages run their blocks through it."""
    B, T, d = x.shape
    head_dim = d // n_heads
    h = _rmsnorm(x, layer.ln1.to(dtype))
    q, k, v = _qkv(h, layer, dtype, (B, T, n_heads, head_dim))
    o = _kernels.attention(q, k, v, causal=True, mesh=mesh)
    x = x + F.linear(o.reshape(B, T, n_heads * head_dim), layer.wo.to(dtype))
    return _ffn(x, layer, dtype)


def lm_head(x, ln_f, embed, dtype):
    """``apply_fn``'s output: the final rmsnorm and the tied projection,
    f32 logits."""
    return _rmsnorm(x, ln_f.to(dtype)).float() @ embed.T


class _PETable:
    """The sinusoid table, built on the host once and kept per device."""

    def __init__(self, n_rows, d_model):
        self.host = torch.from_numpy(_sinusoid_pe(n_rows, d_model))
        self._on = {}

    def get(self, device, dtype):
        key = (str(device), dtype)
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = self.host.to(device=device, dtype=dtype)
        return t


def _init_fn_for(vocab, d_model, n_heads, n_layers, d_ff, moe_experts=0, moe_every=2):
    head_dim = d_model // n_heads

    def init_fn(seed=0):
        """The JAX package's numpy param tree, draw for draw."""
        rng = np.random.RandomState(seed)

        def w(*shape, scale=None):
            scale = scale or (1.0 / np.sqrt(shape[0]))
            return (rng.randn(*shape) * scale).astype(np.float32)

        params = {"embed": w(vocab, d_model, scale=0.02)}
        for i in range(n_layers):
            layer = params["l%d" % i] = {
                "ln1": np.ones((d_model,), np.float32),
                "ln2": np.ones((d_model,), np.float32),
                "wq": w(d_model, n_heads * head_dim),
                "wk": w(d_model, n_heads * head_dim),
                "wv": w(d_model, n_heads * head_dim),
                "wo": w(n_heads * head_dim, d_model),
            }
            if _is_moe_layer(i, moe_experts, moe_every):
                moe = init_moe_params(rng.randint(1 << 30), d_model, d_ff, moe_experts,
                                      device="cpu")
                layer["moe"] = {k: v.numpy() for k, v in moe.items()}
            else:
                layer["w1"] = w(d_model, d_ff)
                layer["w2"] = w(d_ff, d_model)
        params["ln_f"] = np.ones((d_model,), np.float32)
        return params

    return init_fn


def _rank_slice(r, ranks, per):
    """The columns of local tp rank ``r`` of ``ranks``: all of them for one."""
    return slice(None) if ranks == 1 else slice(r * per, (r + 1) * per)


def _is_moe_layer(i, moe_experts, moe_every):
    return moe_experts > 0 and i % moe_every == moe_every - 1


def transformer_lm(vocab=32000, d_model=512, n_heads=8, n_layers=4,
                   d_ff=2048, dtype=None, moe_experts=0, moe_every=2):
    """Returns ``(init_fn(seed) -> numpy param tree,
    apply_fn(params, tokens, mesh=None) -> f32 logits [B, T, vocab])``;
    ``params`` is ``params_from_jax(init_fn(seed), device, dtype)``, or,
    to train, ``params_from_jax(init_fn(seed), device,
    torch.float32).requires_grad_()`` with ``dtype`` the compute dtype.

    ``moe_experts > 0`` replaces every ``moe_every``-th layer's FFN with a
    Switch-MoE block (``parallel.moe.switch_moe``, d_ff hidden units an
    expert); ``apply_fn`` then returns ``(logits, aux)``, the f32 sum of
    the layers' load-balance losses. A ``mesh`` whose 'sp' axis is > 1 runs
    each layer's attention as ring attention over sp sequence blocks."""
    dtype = _torch_dtype(dtype)
    head_dim = d_model // n_heads
    pe_tables = {}  # T -> _PETable of T rows

    def apply_fn(params, tokens, mesh=None):
        """f32 logits [B, T, vocab] (and the f32 aux loss with MoE layers);
        differentiable in ``params``. Over a mesh that spans processes,
        ``tokens`` and the logits are this process's rows and block of the
        sequence, and ``params`` its shards (:func:`shard_params`)."""
        tokens = torch.as_tensor(tokens, device=params.device).long()
        B, T = tokens.shape
        groups = _axis_groups(mesh)
        sp_grp, tp_grp, ep_grp = groups["sp"], groups["tp"], groups["ep"]
        t_all, offset = T, 0
        if sp_grp is not None and sp_grp.size > 1:
            # this process's block of the sequence: its positional rows
            t_all, offset = T * sp_grp.size, T * sp_grp.index
        if t_all not in pe_tables:
            pe_tables[t_all] = _PETable(t_all, d_model)
        pe = pe_tables[t_all].get(params.device, dtype)[offset:offset + T]
        x = params.embed[tokens].to(dtype) + pe[None]
        aux_total = torch.zeros((), dtype=torch.float32, device=params.device)
        tp = _mesh.axis_size(mesh, "tp") if mesh is not None else 1
        if n_heads % tp or d_ff % tp:
            raise ValueError("n_heads %d and d_ff %d must divide by tp = %d" % (n_heads, d_ff, tp))
        ranks = tp_grp.local if tp_grp is not None else 1  # this process's tp ranks
        heads = n_heads // tp
        for i, layer in enumerate(params.layers):
            h = _mesh.copy_to_axis(_rmsnorm(x, layer.ln1.to(dtype)), tp_grp)
            ws = [w.to(dtype) for w in (layer.wq, layer.wk, layer.wv, layer.wo)]
            out = None
            for r in range(ranks):  # each tp rank on its heads
                cols = _rank_slice(r, ranks, heads * head_dim)
                q, k, v = (F.linear(h, w[cols]).reshape(B, T, heads, head_dim)
                           for w in ws[:3])
                o = _kernels.attention(q, k, v, causal=True, mesh=mesh)
                part = F.linear(o.reshape(B, T, heads * head_dim), ws[3][:, cols])
                out = part if out is None else out + part
            x = x + _mesh.reduce_from_axis(out, tp_grp)
            if _is_moe_layer(i, moe_experts, moe_every):
                h = _rmsnorm(x, layer.ln2.to(dtype))
                h_all = gather_sequence(h, sp_grp)  # the router sees the whole sequence
                y, aux = switch_moe(layer.moe, h_all.reshape(-1, d_model), ep=ep_grp)
                y = y.reshape(B, t_all, d_model)[:, offset:offset + T]
                x = x + y
                aux_total = aux_total + aux
            else:  # each tp rank on its FFN columns
                h = _mesh.copy_to_axis(_rmsnorm(x, layer.ln2.to(dtype)), tp_grp)
                w1, w2 = layer.w1.to(dtype), layer.w2.to(dtype)
                out = None
                for r in range(ranks):
                    cols = _rank_slice(r, ranks, d_ff // tp)
                    part = F.linear(_gelu(F.linear(h, w1[cols])), w2[:, cols])
                    out = part if out is None else out + part
                x = x + _mesh.reduce_from_axis(out, tp_grp)
        logits = lm_head(x, params.ln_f, params.embed, dtype)
        return (logits, aux_total) if moe_experts > 0 else logits

    return (_init_fn_for(vocab, d_model, n_heads, n_layers, d_ff, moe_experts, moe_every),
            apply_fn)


def transformer_lm_serving(vocab=32000, d_model=512, n_heads=8, n_layers=4,
                           d_ff=2048, dtype=None, max_len=256):
    """KV-cached serving twin of :func:`transformer_lm`, on the same
    parameters. Returns ``(init_cache, prefill, decode_step)``:

    - ``init_cache(slots, device=None)`` → cache dict: ``k``/``v``
      ``[L, slots, max_len, H, Dh]`` rings, ``pos_map`` (absolute position
      per ring cell, -1 = empty) and ``length`` per slot, int32.
    - ``prefill(params, cache, tokens[n, T], slots[n], lengths[n],
      mesh=None)`` → ``(cache, last_logits[n, vocab])``: a causal forward
      through :func:`ops.kernels.attention` (ring attention over sp blocks
      when ``mesh``'s 'sp' axis is > 1) whose per-layer K/V are written
      into the cache rows of ``slots``.
    - ``decode_step(params, cache, tokens[slots])`` →
      ``(cache, logits[slots, vocab])``: one token for every slot against
      the cache (inactive slots compute garbage the caller ignores).

    The cache is updated in place; the returned dict is the one passed in.
    """
    dtype = _torch_dtype(dtype)
    head_dim = d_model // n_heads
    scale = 1.0 / math.sqrt(head_dim)
    # absolute positions live past the ring window; size the PE table for
    # the longest total sequence the engine may reach
    pe_rows = max(4 * max_len, 1024)
    pe_table = _PETable(pe_rows, d_model)

    def init_cache(slots, device=None):
        device = resolve_device(device)
        shape = (n_layers, slots, max_len, n_heads, head_dim)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos_map": torch.full((slots, max_len), -1, dtype=torch.int32, device=device),
            "length": torch.zeros((slots,), dtype=torch.int32, device=device),
        }

    @torch.inference_mode()
    def prefill(params, cache, tokens, slots, lengths, mesh=None):
        dev = params.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        slots = torch.as_tensor(slots, device=dev).long()
        lengths = torch.as_tensor(lengths, device=dev).long()
        n, T = tokens.shape
        if T > max_len:
            raise ValueError("prefill bucket %d exceeds KV window %d" % (T, max_len))
        pe = pe_table.get(dev, dtype)[:T]
        x = params.embed[tokens].to(dtype) + pe[None]
        ck, cv = cache["k"], cache["v"]
        for i, layer in enumerate(params.layers):
            h = _rmsnorm(x, layer.ln1.to(dtype))
            q, k, v = _qkv(h, layer, dtype, (n, T, n_heads, head_dim))
            o = _kernels.attention(q, k, v, causal=True, mesh=mesh)
            x = x + F.linear(o.reshape(n, T, d_model), layer.wo.to(dtype))
            x = _ffn(x, layer, dtype)
            ck[i, slots, :T] = k
            cv[i, slots, :T] = v
        # reset the WHOLE ring row of each admitted slot: cells past the
        # prompt stay -1 (empty), so a previous occupant's stale K/V can
        # never leak into the new sequence's attention
        cell = torch.arange(max_len, device=dev)[None, :]
        row = torch.where(cell < lengths[:, None], cell, -1)
        cache["pos_map"][slots] = row.to(torch.int32)
        cache["length"][slots] = lengths.to(torch.int32)
        # rmsnorm and the LM head are per row: take the last prompt row of
        # each sequence first instead of computing [n, T, vocab] logits
        last = x[torch.arange(n, device=dev), lengths - 1]
        xf = _rmsnorm(last, params.ln_f.to(dtype))
        return cache, xf.float() @ params.embed.T

    @torch.inference_mode()
    def decode_step(params, cache, tokens):
        dev = params.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        S = tokens.shape[0]
        pos = cache["length"].long()  # [S] absolute position of the new token
        idx = pos % max_len  # ring cell it lands in
        rows = torch.arange(S, device=dev)
        # same rounding as prefill: embed and PE each cast to the compute
        # dtype BEFORE the add
        pe = pe_table.get(dev, dtype)
        x = params.embed[tokens].to(dtype) + pe[pos.clamp(0, pe_rows - 1)]
        pos_map = cache["pos_map"]
        pos_map[rows, idx] = pos.to(torch.int32)
        mask = (pos_map >= 0) & (pos_map <= pos[:, None])  # [S, M]
        ck, cv = cache["k"], cache["v"]
        for i, layer in enumerate(params.layers):
            h = _rmsnorm(x, layer.ln1.to(dtype))
            q, k, v = _qkv(h, layer, dtype, (S, n_heads, head_dim))
            ck[i, rows, idx] = k
            cv[i, rows, idx] = v
            # same numerics as reference_attention: f32 scores and softmax
            s = torch.einsum("shd,smhd->shm", q, ck[i]).float() * scale
            s = s.masked_fill(~mask[:, None, :], _NEG_INF)
            prob = torch.softmax(s, dim=-1)
            o = torch.einsum("shm,smhd->shd", prob, cv[i].float()).to(dtype)
            x = x + F.linear(o.reshape(S, d_model), layer.wo.to(dtype))
            x = _ffn(x, layer, dtype)
        xf = _rmsnorm(x, params.ln_f.to(dtype))
        cache["length"].add_(1)
        return cache, xf.float() @ params.embed.T

    return init_cache, prefill, decode_step
