"""LARC: layer-wise adaptive rate control around any of the port's
optimizers (counterpart of :mod:`apex_tpu.parallel.LARC`).

Reference: ``apex/parallel/LARC.py:5-107``.  Before the inner step each
leaf's grad is rescaled in fp32 so that its effective lr is
``trust · ‖p‖ / (‖g‖ + wd·‖p‖ + eps)``, clipped to the base lr
(``min(·/lr, 1)``) in clip mode; the weight decay is folded into the
grad (``(g + wd·p) · scale``), and the inner optimizer's
``weight_decay`` is 0 for the call and restored after it, so neither of
its paths (the per-leaf one and the bucketed engine, which both read
``weight_decay`` when they run) applies it again.  A leaf whose param
norm or grad norm is zero keeps its grad as it was.
"""

import torch

from apex_tpu_torch.optimizers.tree import tree_map

__all__ = ["LARC"]


class LARC:
    """Wrap an optimizer of the port: ``LARC(FusedSGD(...))``."""

    def __init__(self, optimizer, trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    def init(self, params, **kw):
        return self.optim.init(params, **kw)

    def _adjust(self, g, p, base_lr, wd):
        g32 = g.to(torch.float32)
        p32 = p.detach().to(torch.float32)
        p_norm = torch.sqrt(torch.sum(torch.square(p32)))
        g_norm = torch.sqrt(torch.sum(torch.square(g32)))
        adaptive_lr = self.trust_coefficient * p_norm / (g_norm + p_norm * wd + self.eps)
        scale = torch.clamp(adaptive_lr / base_lr, max=1.0) if self.clip else adaptive_lr
        ok = (p_norm != 0) & (g_norm != 0)
        return torch.where(ok, (g32 + wd * p32) * scale, g32)

    def update(self, grads, state, params, lr=None, **kw):
        """The adjusted grads through the inner ``update`` at ``lr`` (the
        inner optimizer's own when None), its weight decay held at 0."""
        base_lr = self.optim.lr if lr is None else lr
        wd = self.optim.weight_decay
        with torch.no_grad():
            adj = tree_map(lambda g, p: self._adjust(g, p, base_lr, wd), grads, params)
        saved_wd = self.optim.weight_decay
        try:
            self.optim.weight_decay = 0.0
            return self.optim.update(adj, state, params, lr=base_lr, **kw)
        finally:
            self.optim.weight_decay = saved_wd

    def step(self, grads, state, params, **kw):
        return self.update(grads, state, params, **kw)
