"""DCGAN under mixed precision: the port's twin of
``examples/dcgan/main_amp.py`` (the reference README's
``amp.initialize(num_losses=2)`` scenario: two networks, two optimizers,
two loss scalers).

    python -m apex_tpu_torch.dcgan_main_amp [--steps 20] [--batch-size 32]
    python -m apex_tpu_torch.dcgan_main_amp --device cpu --steps 2 --batch-size 4

A small conv GAN on synthetic 64 x 64 images: bf16 compute with fp32
master weights cast at every use (amp O2's arithmetic), one
``FusedAdam(lr=2e-4, betas=(0.5, 0.999))`` per network, one
:class:`~apex_tpu_torch.amp.scaler.DynamicLossScaler` state per loss,
and each update predicated on its ``grads_finite`` vote.  The widths,
flags and printed lines are the JAX driver's (``--device`` and
``--eager`` added); the data comes from its ``np.random.RandomState(0)``
stream.  Both steps (:func:`make_steps`) are
:class:`~apex_tpu_torch.graphs.CapturedStep`\\ s by default, as the
ImageNet trainer's: the loss, its gradients, the unscale and vote, the
in-place ``FusedAdam`` update and the scaler's update, one CUDA graph
each; ``graphs=False`` (``--eager``) runs them as plain steps.

Layouts: activations are NHWC and kernels HWIO, as in the JAX driver
(the convolutions are :func:`~apex_tpu_torch.contrib.conv_bias_relu.conv_nhwc`,
cuDNN on an NCHW view of the NHWC memory, ``"SAME"`` padded as JAX pads).
``jax.lax.conv_transpose(..., "SAME")`` runs the kernel *unflipped* over
the stride-dilated input, padded ``(pad_a, pad_b)`` by JAX's rule
(:func:`conv_transpose_padding`); ``F.conv_transpose2d`` flips its
kernel and pads ``k - 1 - padding`` below and that plus
``output_padding`` above.  So :func:`deconv_nhwc` flips the HWIO
kernel's spatial axes, lays it out (Cin, Cout, kh, kw) and passes
``padding = k - 1 - pad_a`` and ``output_padding = pad_b - pad_a``
(cropping the high side instead where that is negative).
"""

import argparse
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.contrib.conv_bias_relu.conv_bias_relu import conv_nhwc

__all__ = ["LATENT", "build_args", "conv_transpose_padding", "deconv_nhwc", "init_params",
           "params_from_numpy", "generator", "discriminator", "bce", "make_steps", "run",
           "main"]

LATENT = 64

#: (name, shape) of each network's leaves, the JAX ``init_params`` order
GEN_SHAPES = (("fc", (LATENT, 4 * 4 * 256)), ("d1", (4, 4, 256, 128)),
              ("d2", (4, 4, 128, 64)), ("d3", (4, 4, 64, 3)))
DISC_SHAPES = (("c1", (4, 4, 3, 64)), ("c2", (4, 4, 64, 128)), ("c3", (4, 4, 128, 256)),
               ("fc", (8 * 8 * 256, 1)))

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--compute-dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    p.add_argument("--eager", action="store_true",
                   help="run the steps as plain steps, not captured CUDA graphs")
    return p


def conv_transpose_padding(k: int, s: int):
    """JAX's ``"SAME"`` padding ``(pad_a, pad_b)`` of one spatial dim of
    ``lax.conv_transpose`` (its ``_conv_transpose_padding``): the dilated
    input is padded so that the output is ``in * s``."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


def deconv_nhwc(x, w, stride: int = 2):
    """``lax.conv_transpose(x, w, (stride, stride), "SAME",
    ("NHWC", "HWIO", "NHWC"))`` through ``F.conv_transpose2d``: the
    kernel flipped, ``padding = k - 1 - pad_a`` and the high side padded
    ``pad_b`` by ``output_padding`` (or cropped, where pad_b < pad_a)."""
    pads = [conv_transpose_padding(k, stride) for k in w.shape[:2]]
    y = F.conv_transpose2d(
        x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1).flip(2, 3), stride=stride,
        padding=tuple(k - 1 - a for k, (a, _) in zip(w.shape[:2], pads)),
        output_padding=tuple(max(b - a, 0) for a, b in pads))
    (ch, cw) = (max(a - b, 0) for a, b in pads)
    if ch or cw:
        y = y[:, :, :y.shape[2] - ch, :y.shape[3] - cw]
    return y.permute(0, 2, 3, 1)


def params_from_numpy(tree, device="cuda"):
    """The JAX ``init_params`` result ``(gen, disc)`` (dicts of numpy
    arrays) as fp32 tensors on ``device``, each requiring grad."""
    from apex_tpu_torch._device import resolve_device

    dev = resolve_device(device)

    def to(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev).requires_grad_(True)

    gen, disc = tree
    return {k: to(v) for k, v in gen.items()}, {k: to(v) for k, v in disc.items()}


def init_params(generator=None, device="cuda"):
    """He-normal params (``normal * sqrt(2 / fan_in)``, fan-in the
    product of all dims but the last, as the JAX driver's) drawn from
    ``generator`` (a CPU ``torch.Generator``, seeded 0 by default)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def he(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32)
                * np.sqrt(2.0 / np.prod(shape[:-1]))).numpy()

    return params_from_numpy(({k: he(s) for k, s in GEN_SHAPES},
                              {k: he(s) for k, s in DISC_SHAPES}), device)


def generator(z, p):
    x = (z @ p["fc"].to(z.dtype)).reshape(-1, 4, 4, 256)
    x = torch.relu(deconv_nhwc(x, p["d1"].to(x.dtype)))           # 8 x 8
    x = torch.relu(deconv_nhwc(x, p["d2"].to(x.dtype)))           # 16 x 16
    return torch.tanh(deconv_nhwc(x, p["d3"].to(x.dtype), stride=4))  # 64 x 64


def discriminator(img, p):
    x = F.leaky_relu(conv_nhwc(img, p["c1"].to(img.dtype), 2), 0.2)   # 32 x 32
    x = F.leaky_relu(conv_nhwc(x, p["c2"].to(x.dtype), 2), 0.2)       # 16 x 16
    x = F.leaky_relu(conv_nhwc(x, p["c3"].to(x.dtype), 2), 0.2)       # 8 x 8
    return x.reshape(x.shape[0], -1) @ p["fc"].to(x.dtype)


def bce(logits, label: float):
    """Stable sigmoid cross entropy in fp32, label 1 = real."""
    logits = logits.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * label
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _leaves(p):
    return [p[k] for k in sorted(p)]


def make_steps(d_opt, g_opt, scaler, compute_dtype=torch.bfloat16, graphs=None):
    """``(d_step, g_step)``, the JAX driver's two jitted steps:

    - ``d_step(disc, d_state, d_ss, gen, real, z) -> d_loss``;
    - ``g_step(gen, g_state, g_ss, disc, z) -> g_loss``.

    Each takes the scaled loss's gradients, unscales them with the vote
    (``scaler.unscale``), runs ``opt.update(..., grads_finite=finite,
    inplace=True)``, writes ``scaler.update`` into its scaler state and
    returns the unscaled loss (the scaled one over the scale it was
    taken at).  The params, optimizer and scaler states are updated in
    place.  Compiled unless ``graphs=False``: a
    :class:`~apex_tpu_torch.graphs.CapturedStep` each."""
    from apex_tpu_torch.optimizers.base import write_into

    def finish(scaled, params, opt, state, ss):
        names = sorted(params)
        grads = torch.autograd.grad(scaled, [params[k] for k in names])
        # a kernel's gradient comes back through the HWIO -> OIHW permute as
        # a strided view; the optimizer's kernel takes contiguous tensors
        grads, finite = scaler.unscale(ss, {k: g.contiguous() for k, g in zip(names, grads)})
        opt.update(grads, state, params, grads_finite=finite, inplace=True)
        loss = scaled.detach() / ss.loss_scale
        write_into(ss, scaler.update(ss, finite))
        return loss

    def d_step(disc, d_state, d_ss, gen, real, z):
        with torch.no_grad():
            fake = generator(z.to(compute_dtype), gen)
        with torch.enable_grad():
            l = (bce(discriminator(real.to(compute_dtype), disc), 1.0)
                 + bce(discriminator(fake, disc), 0.0))
            return finish(scaler.scale(d_ss, l), disc, d_opt, d_state, d_ss)

    def g_step(gen, g_state, g_ss, disc, z):
        with torch.enable_grad():
            fake = generator(z.to(compute_dtype), gen)
            l = bce(discriminator(fake, disc), 1.0)
            return finish(scaler.scale(g_ss, l), gen, g_opt, g_state, g_ss)

    if graphs is False:
        return d_step, g_step
    from apex_tpu_torch.graphs import CapturedStep

    return CapturedStep(d_step, donate=(0, 1, 2, 3)), CapturedStep(g_step, donate=(0, 1, 2, 3))


def batch(rng, batch_size):
    """One step's ``(real (B, 64, 64, 3), z (B, LATENT))`` fp32 numpy, the
    JAX driver's draws."""
    real = rng.rand(batch_size, 64, 64, 3).astype(np.float32) * 2 - 1
    z = rng.randn(batch_size, LATENT).astype(np.float32)
    return real, z


def run(args, params=None):
    """Train ``args.steps`` steps of both networks; returns the report:
    the losses by step, the step ms (the median of the steps after the
    first, host clock around synchronized steps on CUDA), the final loss
    scales, whether the steps replay CUDA graphs, the params and the
    optimizer states.  ``params``: a ``(gen,
    disc)`` pair (e.g. :func:`params_from_numpy`), by default
    :func:`init_params`."""
    from apex_tpu_torch._device import resolve_device
    from apex_tpu_torch.amp.scaler import DynamicLossScaler
    from apex_tpu_torch.optimizers import FusedAdam

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    cd = DTYPES[args.compute_dtype]
    gen, disc = params if params is not None else init_params(device=dev)
    g_opt = FusedAdam(lr=2e-4, betas=(0.5, 0.999))
    d_opt = FusedAdam(lr=2e-4, betas=(0.5, 0.999))
    g_state, d_state = g_opt.init(gen), d_opt.init(disc)
    # one dynamic scaler state per loss: the reference README's num_losses=2
    scaler = DynamicLossScaler()
    g_ss, d_ss = scaler.init(dev), scaler.init(dev)
    d_step, g_step = make_steps(d_opt, g_opt, scaler, cd, graphs=False if args.eager else None)

    rng = np.random.RandomState(0)
    losses, times = [], []
    t0 = time.time()
    for step in range(args.steps):
        real, z = batch(rng, args.batch_size)
        real = torch.from_numpy(real).to(dev)
        z = torch.from_numpy(z).to(dev)
        t = time.perf_counter()
        d_loss = d_step(disc, d_state, d_ss, gen, real, z).clone()
        g_loss = g_step(gen, g_state, g_ss, disc, z).clone()
        if cuda:
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t)
        losses.append((d_loss, g_loss))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step}: d_loss={float(d_loss):.4f} g_loss={float(g_loss):.4f}",
                  flush=True)
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s", flush=True)
    return {
        "losses": [(float(d), float(g)) for d, g in losses],
        "step_ms": float(np.median(times[1:])) * 1e3 if len(times) > 1 else None,
        "loss_scales": (float(d_ss.loss_scale), float(g_ss.loss_scale)),
        "graphs": getattr(d_step, "graph", None) is not None,
        "params": (gen, disc), "states": (d_state, g_state),
    }


def main(argv=None):
    run(build_args().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
