"""Contrib modules of the port (counterpart of :mod:`apex_tpu.contrib`),
each an independent subpackage imported on first use, as the JAX
package's ``_SUBS`` / ``__getattr__`` does: ``optimizers`` (the ZeRO
DistributedFusedAdam / LAMB), ``clip_grad``, ``layer_norm``, ``xentropy``,
``focal_loss``, ``group_norm``, ``index_mul_2d``, ``fmha``,
``multihead_attn``, ``transducer``, ``conv_bias_relu`` and
``openfold_triton``.  Only the ported subpackages are named."""

_SUBS = (
    "optimizers",
    "xentropy",
    "clip_grad",
    "focal_loss",
    "group_norm",
    "layer_norm",
    "index_mul_2d",
    "fmha",
    "multihead_attn",
    "transducer",
    "conv_bias_relu",
    "openfold_triton",
)


def __getattr__(name):
    if name in _SUBS:
        import importlib

        mod = importlib.import_module(f"apex_tpu_torch.contrib.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'apex_tpu_torch.contrib' has no attribute {name!r}")
