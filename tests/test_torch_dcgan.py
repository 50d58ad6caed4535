"""The port's DCGAN driver (``apex_tpu_torch.dcgan_main_amp``) against
the JAX driver (``examples/dcgan/main_amp.py``) on the CPU.

- each transposed convolution of the generator (4 x 4 at stride 2 and
  4) and others of JAX's ``"SAME"`` rule against ``lax.conv_transpose``
  within ``CONV_TOL`` = 2e-6 (fp32, of the largest output; the kernel
  unflipped, the padding derived by :func:`conv_transpose_padding`), and
  the unflipped kernel far from it;
- fp32 steps of both networks from the JAX ``init_params`` tree
  (``params_from_numpy``), batch 4, the JAX driver's ``d_step`` and
  ``g_step`` as written in its ``main``, through the compiled steps
  (their static path on the CPU) and the plain ones (``--eager``), which
  agree bitwise: both losses' gradients at the JAX params within
  ``TOL`` = 1e-5 of each leaf's largest entry; over five steps every
  loss within 1e-5 (relative) and every param within ``ADAM_LR`` = 2e-4
  of JAX's.  Adam normalizes each element's gradient by its own size,
  so an element whose gradient is near its fp32 rounding (ReLU-dead
  units; the smallest is 1e-9 in a leaf whose largest is 1e-2) takes a
  step anywhere in [-lr, lr] on either side: one step leaves 8.9e-6
  between the two, five up to 1.1e-4 (of updates up to 1.1e-3);
- the flags: ``main`` at ``--device cpu`` prints the JAX driver's lines.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.amp.scaler import DynamicLossScaler as JaxScaler
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam

from apex_tpu_torch import dcgan_main_amp as tdc

REPO = Path(__file__).resolve().parent.parent
#: transposed convolutions, fp32, of the largest output entry
CONV_TOL = 2e-6
#: losses (relative) and params (of each leaf's largest entry), fp32
TOL = 1e-5
STEPS, BATCH = 5, 4
#: five steps' params: one Adam step's largest change an element
ADAM_LR = 2e-4


def _jax_driver():
    spec = importlib.util.spec_from_file_location("jax_dcgan_main_amp",
                                                  REPO / "examples/dcgan/main_amp.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JDC = _jax_driver()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: a CPU shared by parallel test workers slows
    many-thread convolutions by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k,s,hw,cin,cout", [(4, 2, 4, 256, 128), (4, 2, 8, 128, 64),
                                             (4, 4, 16, 64, 3), (3, 2, 5, 4, 6),
                                             (5, 2, 6, 3, 2), (2, 2, 3, 2, 3),
                                             (3, 1, 5, 2, 2)])
def test_conv_transpose_matches_jax(k, s, hw, cin, cout):
    """The generator's three layers at their shapes (the first three
    cases), then other kernels and strides of the same rule."""
    rng = np.random.RandomState(k * 10 + s)
    x = rng.randn(2, hw, hw, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    want = np.asarray(JDC._deconv(jnp.asarray(x), jnp.asarray(w), stride=s))
    got = tdc.deconv_nhwc(torch.tensor(x), torch.tensor(w), stride=s).numpy()
    assert got.shape == want.shape == (2, hw * s, hw * s, cout)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= CONV_TOL * scale
    if k > 1:  # the kernel unflipped is another function
        unflipped = tdc.deconv_nhwc(torch.tensor(x), torch.tensor(w).flip(0, 1), stride=s)
        assert np.abs(unflipped.numpy() - want).max() > 1e-2 * scale


def test_conv_transpose_padding_rule():
    """JAX's ``_conv_transpose_padding`` for ``"SAME"``: the output is
    ``in * s``; padding 1 at k 4 / s 2 and 0 at k 4 / s 4."""
    for k in range(1, 7):
        for s in range(1, 5):
            a, b = tdc.conv_transpose_padding(k, s)
            assert a + b == k + s - 2
    assert tdc.conv_transpose_padding(4, 2) == (2, 2)
    assert tdc.conv_transpose_padding(4, 4) == (3, 3)


def _jax_steps(cd=jnp.float32):
    """The JAX driver's ``d_step`` and ``g_step`` as its ``main`` writes
    them."""
    g_opt = JaxFusedAdam(lr=2e-4, betas=(0.5, 0.999))
    d_opt = JaxFusedAdam(lr=2e-4, betas=(0.5, 0.999))
    scaler = JaxScaler()

    @jax.jit
    def d_step(disc, d_state, d_ss, gen, real, z):
        def loss_fn(disc):
            fake = JDC.generator(z.astype(cd), gen)
            l = JDC.bce(JDC.discriminator(real.astype(cd), disc), 1.0) + JDC.bce(
                JDC.discriminator(fake, disc), 0.0)
            return scaler.scale(d_ss, l)

        scaled_loss, grads = jax.value_and_grad(loss_fn)(disc)
        grads, finite = scaler.unscale(d_ss, grads)
        disc, d_state = d_opt.update(grads, d_state, disc, grads_finite=finite)
        return disc, d_state, scaler.update(d_ss, finite), scaled_loss / d_ss.loss_scale

    @jax.jit
    def g_step(gen, g_state, g_ss, disc, z):
        def loss_fn(gen):
            fake = JDC.generator(z.astype(cd), gen)
            return scaler.scale(g_ss, JDC.bce(JDC.discriminator(fake, disc), 1.0))

        scaled_loss, grads = jax.value_and_grad(loss_fn)(gen)
        grads, finite = scaler.unscale(g_ss, grads)
        gen, g_state = g_opt.update(grads, g_state, gen, grads_finite=finite)
        return gen, g_state, scaler.update(g_ss, finite), scaled_loss / g_ss.loss_scale

    return g_opt, d_opt, scaler, d_step, g_step


def _jax_run(tree, steps=STEPS):
    gen, disc = tree
    g_opt, d_opt, scaler, d_step, g_step = _jax_steps()
    g_state, d_state = g_opt.init(gen), d_opt.init(disc)
    g_ss, d_ss = scaler.init(), scaler.init()
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(steps):
        real, z = tdc.batch(rng, BATCH)
        disc, d_state, d_ss, d_loss = d_step(disc, d_state, d_ss, gen, jnp.asarray(real),
                                             jnp.asarray(z))
        gen, g_state, g_ss, g_loss = g_step(gen, g_state, g_ss, disc, jnp.asarray(z))
        losses.append((float(d_loss), float(g_loss)))
    return losses, (gen, disc)


@pytest.fixture(scope="module")
def jax_result():
    tree = jax.tree.map(np.asarray, JDC.init_params(jax.random.PRNGKey(0)))
    return tree, _jax_run(tree)


def _port_run(tree, eager, steps=STEPS):
    args = tdc.build_args().parse_args(["--device", "cpu", "--steps", str(steps),
                                        "--batch-size", str(BATCH),
                                        "--compute-dtype", "float32"]
                                       + (["--eager"] if eager else []))
    return tdc.run(args, params=tdc.params_from_numpy(tree, "cpu"))


def test_batches_are_the_jax_drivers():
    rng_a, rng_b = np.random.RandomState(0), np.random.RandomState(0)
    real, z = tdc.batch(rng_a, 3)
    np.testing.assert_array_equal(real, rng_b.rand(3, 64, 64, 3).astype(np.float32) * 2 - 1)
    np.testing.assert_array_equal(z, rng_b.randn(3, tdc.LATENT).astype(np.float32))


def _check_params(report, want, tol_of):
    for got, w_net in zip(report["params"], want):
        assert sorted(got) == sorted(w_net)
        for k in w_net:
            w = np.asarray(w_net[k])
            err = np.abs(got[k].detach().numpy() - w).max()
            assert err <= tol_of(w), (k, err, tol_of(w))


def test_grads_match_jax(jax_result):
    """The discriminator's and the generator's loss gradients at the
    JAX params on the first batch, fp32."""
    tree = jax_result[0]
    jgen, jdisc = tree
    real, z = tdc.batch(np.random.RandomState(0), BATCH)

    def jd(disc):
        fake = JDC.generator(jnp.asarray(z), jgen)
        return (JDC.bce(JDC.discriminator(jnp.asarray(real), disc), 1.0)
                + JDC.bce(JDC.discriminator(fake, disc), 0.0))

    def jg(gen):
        return JDC.bce(JDC.discriminator(JDC.generator(jnp.asarray(z), gen), jdisc), 1.0)

    gen, disc = tdc.params_from_numpy(tree, "cpu")
    with torch.no_grad():
        fake = tdc.generator(torch.tensor(z), gen)
    d_loss = (tdc.bce(tdc.discriminator(torch.tensor(real), disc), 1.0)
              + tdc.bce(tdc.discriminator(fake, disc), 0.0))
    g_loss = tdc.bce(tdc.discriminator(tdc.generator(torch.tensor(z), gen), disc), 1.0)
    for loss, net, jfn, jnet in ((d_loss, disc, jd, jdisc), (g_loss, gen, jg, jgen)):
        jl, jgrads = jax.value_and_grad(jfn)(jnet)
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=TOL)
        names = sorted(net)
        for k, g in zip(names, torch.autograd.grad(loss, [net[k] for k in names])):
            w = np.asarray(jgrads[k])
            assert np.abs(g.numpy() - w).max() <= TOL * np.abs(w).max(), k


def test_steps_match_jax(jax_result, capsys):
    tree, (jlosses, jparams) = jax_result
    report = _port_run(tree, eager=False)
    eager = _port_run(tree, eager=True)
    out = capsys.readouterr().out
    assert "step 0: d_loss=" in out and f"done: {STEPS} steps in" in out
    np.testing.assert_allclose(np.asarray(report["losses"]), np.asarray(jlosses), rtol=TOL)
    assert report["losses"] == eager["losses"]  # compiled = plain, bitwise
    for a, b in zip(report["params"], eager["params"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    _check_params(report, jparams, lambda w: ADAM_LR)
    assert report["loss_scales"] == (2.0 ** 16, 2.0 ** 16)


def test_forward_shapes_and_bf16():
    """The networks' shapes at the driver's widths, and a bf16 forward
    (the default compute dtype) within 2^-5 of fp32 on the same params."""
    gen, disc = tdc.init_params(device="cpu")
    z = torch.tensor(np.random.RandomState(1).randn(2, tdc.LATENT).astype(np.float32))
    img = tdc.generator(z, gen)
    assert img.shape == (2, 64, 64, 3)
    logits = tdc.discriminator(img, disc)
    assert logits.shape == (2, 1)
    img16 = tdc.generator(z.to(torch.bfloat16), gen)
    assert img16.dtype == torch.bfloat16
    assert (img16.float() - img).abs().max() <= 2.0 ** -5
    assert sorted(gen) == ["d1", "d2", "d3", "fc"] and sorted(disc) == ["c1", "c2", "c3", "fc"]
    assert all(tuple(gen[k].shape) == s for k, s in tdc.GEN_SHAPES)
