"""The PyTorch port's ``RNN`` operator, ``mx.rnn`` cells, ``BucketSentenceIter``,
RNN checkpoints and ``lstm_attention_lm`` held against the JAX package's
on the CPU, with the same seed-made numpy inputs and parameters.

- The ``RNN`` operator in each mode, one and two directions, with and
  without ``state_outputs``: outputs and the gradients of the data, the
  blob and the states at rtol 1e-5 / atol 1e-6; its plain per-step loop
  (``rnn_op.rnn_reference``, the card's comparison) the same. Inter-layer
  dropout draws its masks from the graph's generator, which cannot match
  JAX's threefry bits: it is held by moments and to the plain loop under
  the same draws, and inference equals JAX's.
- Each case of ``tests/test_rnn.py`` built in both packages, with the same
  argument names and output shapes and (bound with the same arrays) the
  same outputs; ``test_fused_unfused_consistency`` across the packages;
  ``pack_weights`` / ``unpack_weights`` / ``unfuse`` and the ``FusedRNN``
  initializer equal to JAX's.
- ``BucketSentenceIter``: the same batches, bucket keys and order.
- ``save_rnn_checkpoint`` files loading in the other package.
- ``lstm_attention_lm``: logits and gradients against JAX's on its
  reference attention (atol 1e-5).
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import name as jname
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch import name as tname
from mxnet_tpu_torch.models import common as tcommon
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import rnn_op

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _host():
    with tmx.cpu():
        yield


def _op_inputs(mode, bidir, T=5, N=3, I=6, H=7, L=2, seed=0):
    rng = np.random.RandomState(seed)
    dirs = 2 if bidir else 1
    psize = rnn_op._rnn_param_size(L, I, H, bidir, mode)
    ins = [rng.randn(T, N, I).astype(np.float32),
           rng.uniform(-0.4, 0.4, psize).astype(np.float32),
           (0.5 * rng.randn(L * dirs, N, H)).astype(np.float32)]
    if mode == "lstm":
        ins.append((0.5 * rng.randn(L * dirs, N, H)).astype(np.float32))
    return ins


def _jax_op(attrs, ins, cot, is_train=True):
    op = jreg.get("RNN")
    a = op.canon_attrs(attrs)
    outs, vjp = jax.vjp(lambda *xs: op.fcompute(a, list(xs), is_train),
                        *[jnp.asarray(x) for x in ins])
    grads = vjp([jnp.asarray(c) for c in cot])
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _torch_op(fn, attrs, ins, cot, is_train=True):
    xs = [torch.tensor(x, requires_grad=True) for x in ins]
    outs = fn(treg.get("RNN").canon_attrs(attrs), xs, is_train)
    grads = torch.autograd.grad(outs, xs, [torch.from_numpy(c) for c in cot])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


@pytest.mark.parametrize("state_outputs", [False, True])
@pytest.mark.parametrize("bidir", [False, True])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
def test_rnn_op_matches_jax(mode, bidir, state_outputs):
    attrs = {"mode": mode, "num_layers": 2, "state_size": 7, "bidirectional": bidir,
             "state_outputs": state_outputs}
    ins = _op_inputs(mode, bidir)
    op = treg.get("RNN")
    _, oshapes, _ = op.infer_shape(op.canon_attrs(attrs), [x.shape for x in ins])
    rng = np.random.RandomState(1)
    cot = [rng.randn(*s).astype(np.float32) for s in oshapes]
    want = _jax_op(attrs, ins, cot)
    for fn in (op.fcompute, rnn_op.rnn_reference):
        got = _torch_op(fn, attrs, ins, cot)
        assert len(got[0]) == len(want[0]) == 1 + state_outputs * (2 if mode == "lstm" else 1)
        for g, w in zip(got[0] + got[1], want[0] + want[1]):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_rnn_op_metadata_matches_jax():
    j, t = jreg.get("RNN"), treg.get("RNN")
    assert t.defaults == j.defaults and t.needs_rng == j.needs_rng
    for attrs in (None, {"mode": "lstm"}, {"mode": "gru"}, {"mode": "rnn_relu",
                                                             "state_outputs": True},
                  {"mode": "lstm", "state_outputs": True}):
        assert t.list_arguments(attrs) == j.list_arguments(attrs), attrs
        assert t.list_outputs(attrs) == j.list_outputs(attrs), attrs
    attrs = {"mode": "lstm", "num_layers": 3, "state_size": 5, "bidirectional": True,
             "state_outputs": True}
    shapes = [(4, 2, 6), None, None, None]
    assert (t.infer_shape(t.canon_attrs(attrs), shapes)
            == tuple(j.infer_shape(j.canon_attrs(attrs), shapes)))


def _dropout_attrs(p, seed):
    attrs = treg.get("RNN").canon_attrs({"mode": "lstm", "num_layers": 3, "state_size": 7,
                                          "p": p})
    attrs["__rng__"] = torch.Generator().manual_seed(seed)
    return attrs


def test_rnn_op_dropout_by_moments_and_against_the_plain_loop():
    """Inter-layer dropout: the op equals the plain loop under the same
    generator draws, and differs across seeds; the masks keep 1 - p of the
    layer outputs within 4 standard deviations and scale them by
    1/(1 - p); out of training the op is JAX's."""
    ins = _op_inputs("lstm", False, L=3)
    xs = [torch.from_numpy(x) for x in ins]
    got = treg.get("RNN").fcompute(_dropout_attrs(0.4, 3), xs, True)[0]
    ref = rnn_op.rnn_reference(_dropout_attrs(0.4, 3), xs, True)[0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)
    other = treg.get("RNN").fcompute(_dropout_attrs(0.4, 4), xs, True)[0]
    assert not torch.equal(got, other)
    plain = treg.get("RNN").fcompute(_dropout_attrs(0.0, 3), xs, True)[0]
    assert not torch.equal(got, plain)
    ones = torch.ones(300, 200)
    for p in (0.2, 0.5):
        y = rnn_op._dropout_mask(ones, p, torch.Generator().manual_seed(5))
        keep = 1.0 - p
        kept = (y != 0).double().mean().item()
        assert abs(kept - keep) <= 4 * np.sqrt(keep * p / y.numel())
        assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1.0 / keep))
    want = jreg.get("RNN").fcompute(jreg.get("RNN").canon_attrs(
        {"mode": "lstm", "num_layers": 3, "state_size": 7, "p": 0.4}),
        [jnp.asarray(x) for x in ins], False)[0]
    inf = treg.get("RNN").fcompute(_dropout_attrs(0.4, 3), xs, False)[0]
    np.testing.assert_allclose(inf.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# -- the cells: tests/test_rnn.py case by case, in both packages ------------
def _forward(pkg, sym, shapes, seed=0, is_train=False):
    """``sym`` bound with ``shapes``, every argument seed-made; outputs as
    numpy."""
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    args = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    exe = sym.simple_bind(pkg.cpu(), **shapes)
    for n, v in args.items():
        exe.arg_dict[n][:] = v
    exe.forward(is_train=is_train)
    return [o.asnumpy() for o in exe.outputs]


def _both(build):
    """``build(pkg)`` in each package inside a fresh NameManager."""
    out = {}
    for pkg, nm in ((jmx, jname), (tmx, tname)):
        with nm.NameManager():
            out[pkg] = build(pkg)
    return out[jmx], out[tmx]


def _same_symbols(jsym, tsym, shapes):
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert tsym.infer_shape(**shapes)[1] == list(jsym.infer_shape(**shapes)[1])
    for g, w in zip(_forward(tmx, tsym, shapes), _forward(jmx, jsym, shapes)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _unroll_group(cell_fn, length, prefix):
    def build(pkg):
        outputs, states = cell_fn(pkg).unroll(length, input_prefix=prefix)
        return pkg.sym.Group(outputs), len(states)
    return build


@pytest.mark.parametrize("case", ["rnn", "lstm", "gru"])
def test_cell_unroll_matches_jax(case):
    """test_rnn_cell_unroll_shapes / test_lstm_cell_unroll /
    test_gru_cell_unroll in both packages."""
    make = {"rnn": lambda pkg: pkg.rnn.RNNCell(10, prefix="rnn_"),
            "lstm": lambda pkg: pkg.rnn.LSTMCell(8, prefix="lstm_"),
            "gru": lambda pkg: pkg.rnn.GRUCell(6, prefix="gru_")}[case]
    (jsym, jn), (tsym, tn) = _both(_unroll_group(make, 3, "x_"))
    assert jn == tn == (2 if case == "lstm" else 1)
    shapes = {"x_t%d_data" % i: (4, 5) for i in range(3)}
    _same_symbols(jsym, tsym, shapes)
    want_h = {"rnn": 10, "lstm": 8, "gru": 6}[case]
    assert tsym.infer_shape(**shapes)[1] == [(4, want_h)] * 3


def test_stack_and_bidirectional_match_jax():
    def stack(pkg):
        cell = pkg.rnn.SequentialRNNCell()
        cell.add(pkg.rnn.LSTMCell(4, prefix="l0_"))
        cell.add(pkg.rnn.LSTMCell(4, prefix="l1_"))
        outputs, states = cell.unroll(2, input_prefix="s_")
        return pkg.sym.Group(outputs), len(states)

    def bi(pkg):
        cell = pkg.rnn.BidirectionalCell(pkg.rnn.LSTMCell(4, prefix="bl_"),
                                         pkg.rnn.LSTMCell(4, prefix="br_"))
        outputs, states = cell.unroll(2, input_prefix="b_")
        return pkg.sym.Group(outputs), len(states)

    (jsym, jn), (tsym, tn) = _both(stack)
    assert jn == tn == 4
    _same_symbols(jsym, tsym, {"s_t0_data": (2, 3), "s_t1_data": (2, 3)})
    (jsym, jn), (tsym, tn) = _both(bi)
    assert jn == tn == 2
    shapes = {"b_t0_data": (2, 3), "b_t1_data": (2, 3)}
    _same_symbols(jsym, tsym, shapes)
    assert tsym.infer_shape(**shapes)[1] == [(2, 8)] * 2


@pytest.mark.parametrize("modifier", ["residual", "zoneout"])
def test_modifier_cells_match_jax(modifier):
    """ResidualCell, and ZoneoutCell out of training (its masks are
    Dropout's, drawn only in training)."""
    def build(pkg):
        base = pkg.rnn.GRUCell(5, prefix="g_")
        cell = (pkg.rnn.ResidualCell(base) if modifier == "residual"
                else pkg.rnn.ZoneoutCell(base, zoneout_outputs=0.3, zoneout_states=0.2))
        outputs, _ = cell.unroll(3, input_prefix="z_")
        return pkg.sym.Group(outputs)

    jsym, tsym = _both(build)
    _same_symbols(jsym, tsym, {"z_t%d_data" % i: (2, 5) for i in range(3)})


def _fused_and_unfused(pkg, mode, bidir, T):
    fused = pkg.rnn.FusedRNNCell(5, num_layers=2, mode=mode, bidirectional=bidir,
                                 prefix="%s_" % mode)
    f_out, _ = fused.unroll(T, inputs=pkg.sym.Variable("data"), layout="TNC")
    unfused = fused.unfuse()
    u_outs, _ = unfused.unroll(T, inputs=list(pkg.sym.SliceChannel(
        pkg.sym.Variable("data"), axis=0, num_outputs=T, squeeze_axis=1)))
    u_out = pkg.sym.Group([pkg.sym.expand_dims(o, axis=0) for o in u_outs])
    return fused, f_out, unfused, u_out


def _bind_run(pkg, sym, x, args):
    exe = sym.simple_bind(pkg.cpu(), data=x.shape)
    exe.arg_dict["data"][:] = x
    matched = 0
    for name, arr in args.items():
        if name in exe.arg_dict:
            exe.arg_dict[name][:] = arr.asnumpy()
            matched += 1
    exe.forward()
    return np.concatenate([o.asnumpy() for o in exe.outputs], axis=0), matched


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("gru", False), ("rnn_tanh", True),
                                        ("lstm", True)])
def test_fused_unfused_consistency_across_packages(mode, bidir):
    """tests/test_rnn.py's core check: the fused cell and its unfused stack
    with the same (repacked) weights, in both packages, all four equal."""
    T, N, I = 3, 2, 4
    rng = np.random.RandomState(0)
    x = rng.rand(T, N, I).astype(np.float32)
    outs = {}
    for pkg, nm in ((jmx, jname), (tmx, tname)):
        with nm.NameManager():
            fused, f_out, unfused, u_out = _fused_and_unfused(pkg, mode, bidir, T)
        blob = np.random.RandomState(1).rand(fused._get_param_size(I)).astype(np.float32) * 0.2
        f_val, _ = _bind_run(pkg, f_out, x, {fused._parameter.name: pkg.nd.array(blob)})
        args = unfused.pack_weights(fused.unpack_weights(
            {fused._parameter.name: pkg.nd.array(blob)}))
        u_val, matched = _bind_run(pkg, u_out, x, args)
        assert matched >= 4
        outs[pkg] = (f_val, u_val, sorted(args))
    assert outs[tmx][2] == outs[jmx][2]
    for got in outs[tmx][:2]:
        for want in outs[jmx][:2]:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outs[tmx][0], outs[jmx][0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("gru", True), ("rnn_relu", False)])
def test_pack_unpack_match_jax(mode, bidir):
    """unpack_weights gives JAX's per-gate arrays; pack_weights rebuilds the
    blob bit for bit (tests/test_rnn.py::test_pack_unpack_roundtrip)."""
    cells = {pkg: pkg.rnn.FusedRNNCell(6, num_layers=2, mode=mode, bidirectional=bidir,
                                       prefix="f_") for pkg in (jmx, tmx)}
    psize = cells[tmx]._get_param_size(4)
    assert psize == cells[jmx]._get_param_size(4)
    blob = np.random.RandomState(2).rand(psize).astype(np.float32)
    unpacked = {pkg: c.unpack_weights({c._parameter.name: pkg.nd.array(blob)})
                for pkg, c in cells.items()}
    assert sorted(unpacked[tmx]) == sorted(unpacked[jmx])
    for k, v in unpacked[jmx].items():
        assert np.array_equal(unpacked[tmx][k].asnumpy(), v.asnumpy()), k
    packed = cells[tmx].pack_weights(unpacked[tmx])
    assert np.array_equal(packed["f_parameters"].asnumpy(), blob)


def test_fused_rnn_initializer_matches_jax():
    """FusedRNN(Xavier) through the unpacked gates, from one numpy seed:
    the same blob in both packages."""
    blobs = {}
    for pkg in (jmx, tmx):
        init = pkg.init.FusedRNN(pkg.init.Xavier(factor_type="in", magnitude=2.34), 5, 2,
                                 "lstm", bidirectional=True)
        arr = pkg.nd.zeros((rnn_op._rnn_param_size(2, 3, 5, True, "lstm"),))
        np.random.seed(4)
        init(pkg.init.InitDesc("lstm_parameters", attrs={"__init__": init.dumps()}), arr)
        blobs[pkg] = arr.asnumpy()
    assert np.abs(blobs[tmx]).max() > 0
    np.testing.assert_array_equal(blobs[tmx], blobs[jmx])


def test_dropout_cell_by_moments_and_out_of_training():
    """tests/test_rnn.py::test_dropout_cell: the shapes; out of training
    the stack is JAX's; in training DropoutCell keeps 1 - p of its inputs."""
    def build(pkg):
        cell = pkg.rnn.SequentialRNNCell()
        cell.add(pkg.rnn.RNNCell(4, prefix="r_"))
        cell.add(pkg.rnn.DropoutCell(0.5, prefix="d_"))
        outputs, _ = cell.unroll(2, input_prefix="x_")
        return pkg.sym.Group(outputs)

    jsym, tsym = _both(build)
    shapes = {"x_t0_data": (2, 3), "x_t1_data": (2, 3)}
    _same_symbols(jsym, tsym, shapes)
    assert tsym.infer_shape(**shapes)[1] == [(2, 4)] * 2
    cell = tmx.rnn.DropoutCell(0.3, prefix="d_")
    out, _ = cell.unroll(1, inputs=[tmx.sym.Variable("x")])
    tmx.random.seed(11)
    y = _forward(tmx, out[0], {"x": (400, 100)}, is_train=True)[0]
    x = _forward(tmx, out[0], {"x": (400, 100)}, is_train=False)[0]
    kept = float((y != 0).mean())
    assert abs(kept - 0.7) <= 4 * np.sqrt(0.7 * 0.3 / y.size)
    np.testing.assert_allclose(y[y != 0], x[y != 0] / 0.7, rtol=1e-6)


# -- BucketSentenceIter ------------------------------------------------------
def _sentences(n=120, seed=9):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, 30, rng.randint(2, 14))] for _ in range(n)]


def _batches(pkg, sentences, **kw):
    random.seed(3)
    np.random.seed(3)
    it = pkg.rnn.BucketSentenceIter(sentences, 8, **kw)
    out = []
    for epoch in range(2):
        for b in it:
            out.append((b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
                        list(b.provide_data[0]), list(b.provide_label[0])))
        it.reset()
    return it, out


@pytest.mark.parametrize("buckets", [[4, 8, 16], None])
def test_bucket_sentence_iter_matches_jax(buckets):
    sentences = _sentences()
    jit_, want = _batches(jmx, sentences, buckets=buckets, invalid_label=0)
    tit, got = _batches(tmx, sentences, buckets=buckets, invalid_label=0)
    assert tit.buckets == jit_.buckets and tit.default_bucket_key == jit_.default_bucket_key
    assert list(tit.provide_data[0]) == list(jit_.provide_data[0])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3:] == w[3:]
        assert np.array_equal(g[1], w[1]) and np.array_equal(g[2], w[2])


def test_encode_sentences_matches_jax():
    words = [["a", "b", "c"], ["b", "d"], ["e", "a", "a"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 1}):
        assert tmx.rnn.encode_sentences(words, **kw) == jmx.rnn.encode_sentences(words, **kw)
    vocab = {"a": 1, "b": 2}
    with pytest.raises(AssertionError):
        tmx.rnn.encode_sentences([["a", "z"]], vocab=vocab)


# -- RNN checkpoints -----------------------------------------------------------
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_rnn_checkpoint_files_load_both_ways(tmp_path, writer):
    """save_rnn_checkpoint unpacks the blob per gate; the other package's
    load_rnn_checkpoint packs it back bit for bit; the symbol crosses too."""
    src, dst = (tmx, jmx) if writer == "port" else (jmx, tmx)
    blob = np.random.RandomState(5).rand(rnn_op._rnn_param_size(2, 4, 6, False, "lstm"))
    blob = blob.astype(np.float32)
    cells, syms = {}, {}
    for pkg, nm in ((jmx, jname), (tmx, tname)):
        cells[pkg] = pkg.rnn.FusedRNNCell(6, num_layers=2, mode="lstm", prefix="lstm_")
        with nm.NameManager():
            syms[pkg], _ = cells[pkg].unroll(3, inputs=pkg.sym.Variable("data"), layout="TNC")
    arg = {"lstm_parameters": src.nd.array(blob), "w": src.nd.array(np.arange(3.0))}
    prefix = str(tmp_path / "rnn")
    src.rnn.save_rnn_checkpoint(cells[src], prefix, 2, syms[src], arg, {})
    _, raw, _ = dst.model.load_checkpoint(prefix, 2)
    assert "lstm_l1_h2h_o_weight" in raw and "lstm_parameters" not in raw
    sym, got, aux = dst.rnn.load_rnn_checkpoint([cells[dst]], prefix, 2)
    assert aux == {} and sorted(got) == ["lstm_parameters", "w"]
    assert np.array_equal(got["lstm_parameters"].asnumpy(), blob)
    assert sym.list_arguments() == syms[dst].list_arguments()
    cb = dst.rnn.do_rnn_checkpoint(cells[dst], str(tmp_path / "cb"), period=2)
    cb(1, syms[dst], got, {})
    assert (tmp_path / "cb-0002.params").exists()


# -- lstm_attention_lm ---------------------------------------------------------
def test_lstm_attention_lm_matches_jax():
    """Logits and every gradient of a cross-entropy loss against JAX's
    (its reference attention on the CPU), atol 1e-5."""
    from mxnet_tpu.models.lstm import lstm_attention_lm as jlm
    from mxnet_tpu_torch.models.lstm import lstm_attention_lm as tlm

    dims = dict(vocab=40, num_hidden=16, num_embed=12, n_heads=2)
    jinit, japply = jlm(**dims)
    tinit, tapply = tlm(**dims)
    host = jinit(3)
    for k, v in tinit(3).items():
        assert np.array_equal(v, host[k]), k
    tokens = np.random.RandomState(6).randint(0, 40, (2, 7))
    tgt = np.random.RandomState(7).randint(0, 40, (2, 7))

    def jloss(params):
        logits = japply(params, jnp.asarray(tokens))
        lp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(lp, jnp.asarray(tgt)[..., None], -1).mean(), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in host.items()})
    params, _ = tcommon.params_from_numpy(host, {}, device="cpu")
    for p in params.values():
        p.requires_grad_()
    logits = tapply(params, torch.from_numpy(tokens))
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 40),
                                             torch.from_numpy(tgt).reshape(-1))
    names = sorted(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[n]), rtol=0, atol=1e-5,
                                   err_msg=n)


def test_lstm_models_build_the_jax_symbols():
    """lstm_unroll, fused_lstm_sym and BucketingLSTMModel: the same
    arguments and output shapes as JAX's."""
    from mxnet_tpu.models import lstm as jlstm
    from mxnet_tpu_torch.models import lstm as tlstm

    for fused in (False, True):
        def build(pkg, fused=fused):
            mod = tlstm if pkg is tmx else jlstm
            return mod.BucketingLSTMModel(2, 20, 8, 6, 20, fused=fused)(5)

        (jsym, jd, jl), (tsym, td, tl) = _both(build)
        assert (td, tl) == (jd, jl)
        shapes = {"data": (3, 5), "softmax_label": (3, 5)}
        assert tsym.list_arguments() == jsym.list_arguments()
        assert tsym.infer_shape(**shapes) == tuple(
            [list(x) for x in jsym.infer_shape(**shapes)])
    assert tmx.models.lstm_unroll is tlstm.lstm_unroll


def test_weights_in_a_gapped_layout_give_the_same_op(monkeypatch):
    """On the card the blob's pieces go to cuDNN's own offsets, gaps
    zeroed: ``place`` puts each piece at its offset, and the op computes
    the same outputs and gradients through a layout with gaps as packed end
    to end."""
    pieces = [torch.arange(6.0).reshape(2, 3), torch.ones(4), torch.full((3,), 2.0)]
    views = rnn_op.place(pieces, 20, [10, 0, 5])
    assert all(torch.equal(v, p) for v, p in zip(views, pieces))
    flat = views[1]._base if views[1]._base is not None else views[1]
    assert flat.numel() == 20 and float(flat[4]) == 0.0 and float(flat[16:].abs().sum()) == 0.0
    attrs = {"mode": "gru", "num_layers": 2, "state_size": 7, "bidirectional": True,
             "state_outputs": True}
    ins = _op_inputs("gru", True)
    op = treg.get("RNN")
    _, oshapes, _ = op.infer_shape(op.canon_attrs(attrs), [x.shape for x in ins])
    cot = [np.random.RandomState(2).randn(*s).astype(np.float32) for s in oshapes]
    want = _torch_op(op.fcompute, attrs, ins, cot)

    def gapped(pieces, *args):
        offsets, pos = [], 3
        for p in reversed(pieces):  # reversed order, a gap of 3 before each
            offsets.insert(0, pos)
            pos += p.numel() + 3
        return pos + 5, offsets

    monkeypatch.setattr(rnn_op, "_cudnn_layout", gapped)
    got = _torch_op(op.fcompute, attrs, ins, cot)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g, w)
