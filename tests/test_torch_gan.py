"""The port's counterpart of ``tests/test_gan.py``'s adversarial loop:
``examples/train_gan.py``'s ``build_modules`` handed the port's package
builds the generator and the discriminator (``inputs_need_grad``), and
the discriminator's input gradients drive the generator's backward
(``get_input_grads`` into ``backward(out_grads)``) for 30 steps on the
host: the signal flows every step, moves every generator parameter, and
the discriminator learns to tell real from fake."""
import importlib.util
import os

import numpy as np

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.io import DataBatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example():
    spec = importlib.util.spec_from_file_location(
        "train_gan", os.path.join(REPO, "examples", "train_gan.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_adversarial_loop_mechanism():
    m = _example()
    rng = np.random.RandomState(0)
    batch, nz = 32, 8
    with tmx.cpu():
        tmx.random.seed(0)
        np.random.seed(0)
        gen, disc = m.build_modules(tmx, batch, nz, lr=0.01)
        assert disc.inputs_need_grad
        ones, zeros = tmx.nd.ones((batch, 1)), tmx.nd.zeros((batch, 1))
        g0 = {k: v.asnumpy().copy() for k, v in gen.get_params()[0].items()}

        def real_batch():
            return tmx.nd.array((m.TARGET_MEAN + 0.3 * rng.randn(batch, 2)).astype(np.float32))

        grad_mags = []
        for _ in range(30):
            noise = tmx.nd.array(rng.randn(batch, nz).astype(np.float32))
            gen.forward(DataBatch(data=[noise], label=[]), is_train=True)
            fake = gen.get_outputs()[0]
            disc.forward(DataBatch(data=[real_batch()], label=[ones]), is_train=True)
            disc.backward()
            disc.update()
            disc.forward(DataBatch(data=[fake], label=[zeros]), is_train=True)
            disc.backward()
            disc.update()
            disc.forward(DataBatch(data=[fake], label=[ones]), is_train=True)
            disc.backward()
            g = disc.get_input_grads()[0]
            assert g.shape == (batch, 2)
            grad_mags.append(float(np.abs(g.asnumpy()).max()))
            gen.backward([g])
            gen.update()
        assert min(grad_mags) > 0, grad_mags
        g1 = gen.get_params()[0]
        deltas = {k: float(np.abs(g1[k].asnumpy() - g0[k]).max()) for k in g0}
        assert all(d > 0 for d in deltas.values()), deltas
        disc.forward(DataBatch(data=[real_batch()], label=[ones]), is_train=False)
        p_real = disc.get_outputs()[0].asnumpy().mean()
        gen.forward(DataBatch(data=[tmx.nd.array(rng.randn(batch, nz).astype(np.float32))],
                              label=[]), is_train=True)
        disc.forward(DataBatch(data=[gen.get_outputs()[0]], label=[zeros]), is_train=False)
        p_fake = disc.get_outputs()[0].asnumpy().mean()
        assert p_real > p_fake + 0.05, (p_real, p_fake)
