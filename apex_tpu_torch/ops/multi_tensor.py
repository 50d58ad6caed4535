"""Multi-tensor primitives and the optimizer engine's kernels
(counterpart of :mod:`apex_tpu.ops.multi_tensor`).

**The kernels** (``csrc/multi_tensor.cu``), each with its plain PyTorch
version and a launch counter:

- :func:`mt_adam` (``ADAM_LAUNCHES``): one pass of Adam/AdamW over a
  list of leaves: reads g, p (or the fp32 master), m and v, writes p in
  its storage dtype, m, v (and the master), predicated on a device
  flag, with a device clip coefficient and per-tensor lr / weight decay;
- :func:`mt_scale` (``SCALE_LAUNCHES``): ``out = float(x) * mult`` into
  outputs of any float dtype, raising a device flag where an output is
  not finite: the engine's pack, unscale and finite vote in one read;
- :func:`mt_l2norm` (``L2NORM_LAUNCHES``): each leaf's sum of squares
  and their sum, in fp32, in a fixed order (no atomics);
- :func:`mt_adam_remainder` (``REMAINDER_LAUNCHES``): the ZeRO shard
  update with ``store_param_remainders``: the fp32 master rebuilt from
  the bf16 param and its uint16 remainder (``(bits << 16) | rem``),
  :func:`mt_adam`'s step, the new master split back into its high half
  (the bf16 param) and its low half (the remainder).

They replace no Pallas kernel: the JAX package's engine is tree math
that XLA fuses.  A kernel reads each leaf where it lies through a table
of pointers passed by value (<= 4 KB a launch), as apex's
``multi_tensor_apply`` does; :func:`mt_plan` states the launches a call
makes (ceil(T / capacity), fewer when a group of tensors is empty;
twice that for the l2 norm's two stages), and ``chip_smoke.py`` holds
it against the C entry ``apex_mt_plan``.  Each wrapper runs its plain
version for CPU tensors, and only for them: on CUDA tensors it launches
its kernel or raises.

**The tree ops** (:func:`tree_not_finite`, :func:`all_finite`,
:func:`multi_tensor_scale`, :func:`multi_tensor_axpby`,
:func:`multi_tensor_l2norm`, :func:`multi_tensor_norm_blend`,
:func:`tree_where`) take a tree of tensors or a
:class:`~apex_tpu_torch.optimizers.bucketing.Buckets`; the reductions
read a ``Buckets`` per original leaf through its plan.
"""

import ctypes
from typing import Any, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.ops import _build

Tree = Any

#: kernel launches by :func:`mt_adam`, :func:`mt_scale`, :func:`mt_l2norm`
#: (each launch counts one; a call makes :func:`mt_plan`'s ``launches``)
ADAM_LAUNCHES = 0
SCALE_LAUNCHES = 0
L2NORM_LAUNCHES = 0
REMAINDER_LAUNCHES = 0

#: ``csrc/multi_tensor.cu``: elements a block, threads a block, the
#: kernel-parameter table's limit, and the tensors a table holds
CHUNK = 16384
THREADS = 256
TABLE_BYTES = 4096
CAPACITY = {"adam": 45, "scale": 126, "l2norm": 183, "adam_remainder": 42}
#: ``sizeof`` of each table (the launch's parameter bytes)
TABLE_SIZES = {"adam": 4040, "scale": 4064, "l2norm": 4080, "adam_remainder": 4024}
#: the C entries' kernel codes (``apex_mt_plan``)
KINDS = {"adam": 0, "scale": 1, "l2norm": 2, "adam_remainder": 3}

#: torch dtype -> the kernels' dtype code
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class MtPlan(NamedTuple):
    capacity: int     # tensors a launch's table holds
    chunk: int        # elements a block
    threads: int      # threads a block
    launches: int     # launches of the call (both stages for the l2 norm)
    chunks: int       # blocks of the call, all launches
    table_bytes: int  # the table's size, the launch's parameter bytes


def mt_plan(kind: str, sizes: Sequence[int]) -> MtPlan:
    """The launch plan of a ``kind`` (``"adam"``, ``"scale"``,
    ``"l2norm"``) call over tensors of ``sizes`` elements, as the C
    entries make it: consecutive groups of ``CAPACITY[kind]`` tensors,
    one launch a group with any element (the l2 norm: a partial-sum
    launch a group with any element and a per-leaf launch every group),
    ceil(size / CHUNK) blocks a tensor."""
    cap = CAPACITY[kind]
    launches = chunks = 0
    for first in range(0, len(sizes), cap):
        c = sum(-(-int(n) // CHUNK) for n in sizes[first:first + cap])
        chunks += c
        launches += (c > 0) + (kind == "l2norm")
    return MtPlan(cap, CHUNK, THREADS, launches, chunks, TABLE_SIZES[kind])


# ---------------------------------------------------------------- math
def sqrt_rn(x):
    """The correctly rounded square root of an fp32 tensor, as the card's
    ``sqrt`` (the kernels' ``__fsqrt_rn``) and XLA's give it.  On the CPU
    torch's vectorized fp32 ``sqrt`` can be an ulp off; the fp64 root
    rounded once to fp32 is the correctly rounded one."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def adam_core(g, m, v, bc1, bc2, *, beta1, beta2, eps):
    """New moments and the core update ``m_hat / (sqrt(v_hat) + eps)``,
    in the association of the JAX package's ``adam_core``."""
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * (g * g)
    core = (m_new / bc1) / (sqrt_rn(v_new / bc2) + eps)
    return core, m_new, v_new


def adam_math(g, p32, m, v, wd_i, lr_i, bc1, bc2, *, beta1, beta2, eps, adam_w_mode):
    """One Adam step per element (AdamW / L2 mode), the JAX package's
    ``adam_math``: the numerics every path and the kernel share."""
    if not adam_w_mode:
        g = g + wd_i * p32
    core, m_new, v_new = adam_core(g, m, v, bc1, bc2, beta1=beta1, beta2=beta2, eps=eps)
    update = core + wd_i * p32 if adam_w_mode else core
    return p32 - lr_i * update, m_new, v_new


# ------------------------------------------------------------ helpers
def _flat(tensors, dtype=torch.float32):
    parts = [t.reshape(-1).to(dtype) for t in tensors]
    if not parts:
        return torch.zeros(0, dtype=dtype)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _per_element(values, sizes, device):
    """A per-tensor operand as the plain versions use it: the value
    itself when every tensor has the same Python float, else an fp32
    vector (a float filled, a 0-d tensor expanded)."""
    if all(isinstance(v, float) for v in values) and len(set(values)) <= 1:
        return values[0] if values else 0.0
    if all(v is values[0] for v in values):
        return values[0]
    return torch.cat([v.to(torch.float32).reshape(1).expand(n) if isinstance(v, torch.Tensor)
                      else torch.full((n,), float(v), dtype=torch.float32, device=device)
                      for v, n in zip(values, sizes)])


def _unpack_into(flat, outs):
    off = 0
    for o in outs:
        n = o.numel()
        o.copy_(flat[off:off + n].view(o.shape))
        off += n


def _lr_table(lr, lr_abs, lr_scale, n):
    """Each tensor's lr as the JAX package's ``leaf_lr`` forms it:
    ``[(value, from_lr), ...]`` where ``from_lr`` means the runtime lr (a
    0-d tensor) times ``value``, the group's scale, multiplied on the
    device; else ``value`` is the lr itself, a group's absolute lr or a
    float runtime lr times the scale (a Python product in double)."""
    lr_abs = lr_abs or [None] * n
    lr_scale = lr_scale or [1.0] * n
    tensor = isinstance(lr, torch.Tensor)
    return [(float(a), False) if a is not None
            else (float(s), True) if tensor else (float(lr) * float(s), False)
            for a, s in zip(lr_abs, lr_scale)]


def _check(what, tensors, dtypes=None):
    """Raise unless every tensor is a contiguous CUDA tensor on one
    device, of a dtype the kernels take (``dtypes``)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: tensors must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.dtype not in (dtypes or DTYPE_CODES):
            raise ValueError(f"{what}: dtype {t.dtype} is not supported")
    return dev


def _scalar_ptr(t, what, dtype=torch.float32):
    """The pointer of a 0-d device operand (or 0 for None)."""
    if t is None:
        return None
    if not isinstance(t, torch.Tensor) or t.numel() != 1 or t.dtype != dtype \
            or t.device.type != "cuda":
        raise ValueError(f"{what} must be a one-element {dtype} CUDA tensor, got {t!r}")
    return t.data_ptr()


def _ptr_array(tensors):
    return np.array([0 if t is None else t.data_ptr() for t in tensors], dtype=np.uint64)


def _np_ptr(a):
    return a.ctypes.data


# ------------------------------------------------------------- mt_adam
def mt_adam_plain(g, p, m, v, p_out, m_out, v_out, master_out, *, lr, wd, bc1, bc2,
                  beta1, beta2, eps, adam_w_mode, lr_abs=None, lr_scale=None, pred=None,
                  coef=None):
    """The plain version: the JAX package's bucket path written out.
    Pack g (times ``coef``), p, m and v into flat fp32 buffers, evaluate
    :func:`adam_math` once over them with per-element lr and weight
    decay (a scalar where every tensor agrees), select the old values
    where ``pred`` is false, and slice the results into the outputs."""
    sizes = [t.numel() for t in g]
    dev = g[0].device
    G = _flat(g)
    if coef is not None:
        G = G * coef
    P, M, V = _flat(p), _flat(m), _flat(v)
    lrs = [(lr if v == 1.0 else lr * v) if from_lr else v
           for v, from_lr in _lr_table(lr, lr_abs, lr_scale, len(g))]
    p_new, m_new, v_new = adam_math(
        G, P, M, V, _per_element([float(w) for w in wd], sizes, dev),
        _per_element(lrs, sizes, dev), bc1, bc2, beta1=beta1, beta2=beta2, eps=eps,
        adam_w_mode=adam_w_mode)
    if pred is not None:
        p_new, m_new, v_new = (torch.where(pred, n, o)
                               for n, o in ((p_new, P), (m_new, M), (v_new, V)))
    _unpack_into(p_new, p_out)
    _unpack_into(m_new, m_out)
    _unpack_into(v_new, v_out)
    if master_out is not None:
        _unpack_into(p_new, master_out)


def mt_adam(g, p, m, v, p_out, m_out, v_out, master_out=None, *, lr, wd, bc1, bc2,
            beta1, beta2, eps, adam_w_mode, lr_abs=None, lr_scale=None, pred=None,
            coef=None):
    """One Adam/AdamW step over the tensors of ``g`` (grads, any float
    dtype), ``p`` (the math's params: the fp32 master or the params),
    ``m`` and ``v`` (fp32), written into ``p_out`` (storage dtype),
    ``m_out``, ``v_out`` and ``master_out`` (fp32, or None).  Index i of
    every list is one tensor of one size.  ``lr``: the runtime lr (a
    float or a 0-d fp32 tensor); ``lr_abs`` / ``lr_scale``: per tensor,
    a group's absolute lr (or None) and its lr scale; ``wd``: per-tensor
    weight decay (floats); ``bc1``, ``bc2``: 0-d fp32 tensors; ``pred``:
    a 0-d bool tensor, false keeps every old value; ``coef``: a 0-d fp32
    clip coefficient multiplied into g.  Nothing given is modified."""
    if not g:
        return
    if g[0].device.type == "cpu":
        return mt_adam_plain(g, p, m, v, p_out, m_out, v_out, master_out, lr=lr, wd=wd,
                             bc1=bc1, bc2=bc2, beta1=beta1, beta2=beta2, eps=eps,
                             adam_w_mode=adam_w_mode, lr_abs=lr_abs, lr_scale=lr_scale,
                             pred=pred, coef=coef)
    T = len(g)
    outs = (p_out, m_out, v_out) + ((master_out,) if master_out is not None else ())
    if any(len(x) != T for x in (p, m, v) + outs) or len(wd) != T:
        raise ValueError("mt_adam: every list must hold one tensor per grad")
    fp32 = (torch.float32,)
    dev = _check("mt_adam", list(g) + list(p) + list(p_out))
    _check("mt_adam", list(m) + list(v) + list(m_out) + list(v_out)
           + list(master_out or ()), fp32)
    for k in range(T):
        n = g[k].numel()
        if any(x[k].numel() != n for x in (p, m, v) + outs):
            raise ValueError(f"mt_adam: tensor {k} differs in size across the lists")
    lrs = _lr_table(lr, lr_abs, lr_scale, T)
    lr_vals = np.array([v for v, _ in lrs], dtype=np.float32)
    ptrs = np.concatenate([_ptr_array(x) for x in (
        g, p, m, v, p_out, m_out, v_out, master_out or [None] * T)])
    codes = np.concatenate([
        np.array([DTYPE_CODES[t.dtype] for t in g], np.uint8),
        np.array([DTYPE_CODES[t.dtype] for t in p], np.uint8),
        np.array([DTYPE_CODES[t.dtype] for t in p_out], np.uint8),
        np.array([from_lr for _, from_lr in lrs], np.uint8)])
    n = np.array([t.numel() for t in g], dtype=np.int64)
    wd_vals = np.array([float(w) for w in wd], dtype=np.float32)
    f32 = lambda x: float(np.float32(x))  # noqa: E731 -- the one rounding to fp32
    launches = ctypes.c_int(0)
    lib, stream = _build.prepare(dev)
    _build.check(lib.apex_mt_adam(
        _np_ptr(ptrs), _np_ptr(n), _np_ptr(lr_vals), _np_ptr(wd_vals), _np_ptr(codes), T,
        _scalar_ptr(bc1, "bc1"), _scalar_ptr(bc2, "bc2"),
        _scalar_ptr(pred, "pred", torch.bool), _scalar_ptr(coef, "coef"),
        _scalar_ptr(lr, "lr") if isinstance(lr, torch.Tensor) else None,
        f32(beta1), f32(1.0 - beta1), f32(beta2), f32(1.0 - beta2), f32(eps),
        int(adam_w_mode), stream, ctypes.addressof(launches)), "mt_adam")
    global ADAM_LAUNCHES
    ADAM_LAUNCHES += launches.value


# --------------------------------------------------- mt_adam_remainder
def master_from_remainder(p_bf16, rem_u16):
    """The fp32 master ``(bits(p) << 16) | rem`` of a bf16 param and its
    uint16 remainder, bit-exactly (the JAX package's
    ``_master_from_remainder``)."""
    hi = p_bf16.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    lo = rem_u16.to(torch.int64)
    return ((hi << 16) | lo).to(torch.int32).view(torch.float32)


def split_master(master_f32):
    """``(bf16 param, uint16 remainder)``: the master's high and low 16
    bits, truncation (the JAX package's ``_split_master``)."""
    bits = master_f32.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return ((bits >> 16).to(torch.uint16).view(torch.bfloat16),
            (bits & 0xFFFF).to(torch.uint16))


def mt_adam_remainder_plain(g, p, rem, m, v, p_out, rem_out, m_out, v_out, *, lr, wd, bc1,
                            bc2, beta1, beta2, eps, adam_w_mode, pred=None, coef=None):
    """The plain version: the JAX package's remainder path written out.
    Rebuild the fp32 masters (:func:`master_from_remainder`), evaluate
    :func:`adam_math` over the packed buffers (g times ``coef``), keep
    the old values where ``pred`` is false, split the new masters
    (:func:`split_master`) into the outputs."""
    sizes = [t.numel() for t in g]
    dev = g[0].device
    G = _flat(g)
    if coef is not None:
        G = G * coef
    P = master_from_remainder(torch.cat([t.reshape(-1) for t in p]),
                              torch.cat([t.reshape(-1) for t in rem]))
    M, V = _flat(m), _flat(v)
    lrs = [v_ for v_, _ in _lr_table(lr, None, None, len(g))]
    lr_op = lr if isinstance(lr, torch.Tensor) else _per_element(lrs, sizes, dev)
    p_new, m_new, v_new = adam_math(
        G, P, M, V, _per_element([float(w) for w in wd], sizes, dev), lr_op, bc1, bc2,
        beta1=beta1, beta2=beta2, eps=eps, adam_w_mode=adam_w_mode)
    if pred is not None:
        p_new, m_new, v_new = (torch.where(pred, n, o)
                               for n, o in ((p_new, P), (m_new, M), (v_new, V)))
    hi, lo = split_master(p_new)
    _unpack_into(hi, p_out)
    _unpack_into(lo, rem_out)
    _unpack_into(m_new, m_out)
    _unpack_into(v_new, v_out)


def mt_adam_remainder(g, p, rem, m, v, p_out, rem_out, m_out, v_out, *, lr, wd, bc1, bc2,
                      beta1, beta2, eps, adam_w_mode, pred=None, coef=None):
    """One Adam/AdamW step over tensors whose fp32 master is stored as a
    bf16 param ``p`` and its uint16 remainder ``rem``: ``g`` (fp32 or
    half grads), ``m``, ``v`` (fp32) in; ``p_out`` (bf16), ``rem_out``
    (uint16), ``m_out``, ``v_out`` out.  ``lr``: a float or a 0-d fp32
    tensor; ``wd``: per-tensor floats; ``bc1``, ``bc2``, ``pred``,
    ``coef`` as :func:`mt_adam` takes them.  Nothing given is
    modified."""
    if not g:
        return
    if g[0].device.type == "cpu":
        return mt_adam_remainder_plain(g, p, rem, m, v, p_out, rem_out, m_out, v_out, lr=lr,
                                       wd=wd, bc1=bc1, bc2=bc2, beta1=beta1, beta2=beta2,
                                       eps=eps, adam_w_mode=adam_w_mode, pred=pred, coef=coef)
    T = len(g)
    lists = (p, rem, m, v, p_out, rem_out, m_out, v_out)
    if any(len(x) != T for x in lists) or len(wd) != T:
        raise ValueError("mt_adam_remainder: every list must hold one tensor per grad")
    dev = _check("mt_adam_remainder", list(g))
    _check("mt_adam_remainder", list(p) + list(p_out), (torch.bfloat16,))
    _check("mt_adam_remainder", list(rem) + list(rem_out), (torch.uint16,))
    _check("mt_adam_remainder", list(m) + list(v) + list(m_out) + list(v_out),
           (torch.float32,))
    for k in range(T):
        n = g[k].numel()
        if any(x[k].numel() != n for x in lists):
            raise ValueError(f"mt_adam_remainder: tensor {k} differs in size across the lists")
    lrs = _lr_table(lr, None, None, T)
    lr_vals = np.array([v_ for v_, _ in lrs], dtype=np.float32)
    ptrs = np.concatenate([_ptr_array(x) for x in (g,) + lists])
    codes = np.concatenate([np.array([DTYPE_CODES[t.dtype] for t in g], np.uint8),
                            np.array([from_lr for _, from_lr in lrs], np.uint8)])
    n = np.array([t.numel() for t in g], dtype=np.int64)
    wd_vals = np.array([float(w) for w in wd], dtype=np.float32)
    f32 = lambda x: float(np.float32(x))  # noqa: E731 -- the one rounding to fp32
    launches = ctypes.c_int(0)
    lib, stream = _build.prepare(dev)
    _build.check(lib.apex_mt_adam_remainder(
        _np_ptr(ptrs), _np_ptr(n), _np_ptr(lr_vals), _np_ptr(wd_vals), _np_ptr(codes), T,
        _scalar_ptr(bc1, "bc1"), _scalar_ptr(bc2, "bc2"),
        _scalar_ptr(pred, "pred", torch.bool), _scalar_ptr(coef, "coef"),
        _scalar_ptr(lr, "lr") if isinstance(lr, torch.Tensor) else None,
        f32(beta1), f32(1.0 - beta1), f32(beta2), f32(1.0 - beta2), f32(eps),
        int(adam_w_mode), stream, ctypes.addressof(launches)), "mt_adam_remainder")
    global REMAINDER_LAUNCHES
    REMAINDER_LAUNCHES += launches.value


# ------------------------------------------------------------ mt_scale
def mt_scale_plain(src, out, mult):
    """The plain version: ``out[i] = float(src[i]) * mult`` cast to
    ``out[i]``'s dtype; returns a 0-d bool tensor, True where any output
    is not finite."""
    for s, o in zip(src, out):
        o.copy_((s.to(torch.float32) * mult).reshape(o.shape))
    return torch.logical_not(all_finite(list(out)))


def mt_scale(src, out, mult):
    """``out[i] = float(src[i]) * mult`` for every tensor, ``mult`` a
    float or a 0-d fp32 tensor; returns a 0-d bool tensor on the device,
    True where any OUTPUT element is not finite (after its cast: an
    overflow of the multiply or of the cast counts)."""
    if not src:
        return torch.zeros((), dtype=torch.bool)
    if src[0].device.type == "cpu":
        return mt_scale_plain(src, out, mult)
    T = len(src)
    if len(out) != T or any(s.numel() != o.numel() for s, o in zip(src, out)):
        raise ValueError("mt_scale: src and out must pair tensors of equal size")
    dev = _check("mt_scale", list(src) + list(out))
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    mult_t = isinstance(mult, torch.Tensor)
    codes = np.array([DTYPE_CODES[t.dtype] for t in src]
                     + [DTYPE_CODES[t.dtype] for t in out], dtype=np.uint8)
    n = np.array([t.numel() for t in src], dtype=np.int64)
    sp, op = _ptr_array(src), _ptr_array(out)
    launches = ctypes.c_int(0)
    lib, stream = _build.prepare(dev)
    _build.check(lib.apex_mt_scale(
        _np_ptr(sp), _np_ptr(op), _np_ptr(n), _np_ptr(codes), T,
        _scalar_ptr(mult, "mult") if mult_t else None,
        0.0 if mult_t else float(np.float32(mult)), flag.data_ptr(), stream,
        ctypes.addressof(launches)), "mt_scale")
    global SCALE_LAUNCHES
    SCALE_LAUNCHES += launches.value
    return flag[0] != 0


# ----------------------------------------------------------- mt_l2norm
def mt_l2norm_plain(tensors):
    """The plain version, the JAX package's tree path: each tensor's
    ``sum(square(float(x)))`` and their stacked sum; returns ``(total
    (0-d), per_tensor (T,))`` fp32."""
    sq = [torch.sum(torch.square(t.to(torch.float32))) for t in tensors]
    per = torch.stack(sq)
    return per.sum(), per


def mt_l2norm(tensors):
    """Each tensor's sum of squares and their sum, in fp32: ``(total
    (0-d), per_tensor (T,))``.  The kernel sums per-chunk partials, then
    each tensor's partials in chunk order, then the tensors in order:
    another order than the plain version's (a relative difference of
    order 1e-7), the same in every call."""
    if not tensors:
        z = torch.zeros((), dtype=torch.float32)
        return z, torch.zeros(0, dtype=torch.float32)
    if tensors[0].device.type == "cpu":
        return mt_l2norm_plain(tensors)
    dev = _check("mt_l2norm", list(tensors))
    T = len(tensors)
    sizes = [t.numel() for t in tensors]
    plan = mt_plan("l2norm", sizes)
    partial = torch.empty(max(plan.chunks, 1), dtype=torch.float32, device=dev)
    per = torch.empty(T, dtype=torch.float32, device=dev)
    total = torch.empty(1, dtype=torch.float32, device=dev)
    codes = np.array([DTYPE_CODES[t.dtype] for t in tensors], dtype=np.uint8)
    n = np.array(sizes, dtype=np.int64)
    sp = _ptr_array(tensors)
    launches = ctypes.c_int(0)
    lib, stream = _build.prepare(dev)
    _build.check(lib.apex_mt_l2norm(
        _np_ptr(sp), _np_ptr(n), _np_ptr(codes), T, partial.data_ptr(), per.data_ptr(),
        total.data_ptr(), stream, ctypes.addressof(launches)), "mt_l2norm")
    global L2NORM_LAUNCHES
    L2NORM_LAUNCHES += launches.value
    return total[0], per


# ---------------------------------------------------------- tree ops
def _leaves(tree):
    from apex_tpu_torch.optimizers.tree import tree_leaves

    return tree_leaves(tree)


def _per_leaf_views(tree) -> List[torch.Tensor]:
    """The tensors a reduction reads: a ``Buckets``' per-leaf slices
    (per ORIGINAL leaf, through the plan), else the tree's leaves."""
    from apex_tpu_torch.optimizers.bucketing import Buckets

    if isinstance(tree, Buckets):
        return tree.leaf_views()
    return _leaves(tree)


def all_finite(tree) -> torch.Tensor:
    """True iff every element of every tensor leaf is finite: the one
    vote implementation (the port's copy of
    ``apex_tpu.amp.scaler.all_finite``), a 0-d bool tensor."""
    leaves = [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]
    if not leaves:
        return torch.ones((), dtype=torch.bool)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


def tree_not_finite(tree) -> torch.Tensor:
    """True if ANY element of the tree is inf/nan (the noop flag).  On
    a ``Buckets`` the vote is over the buffers, whose pads are zero."""
    return torch.logical_not(all_finite(tree))


def multi_tensor_scale(src: Tree, scale, out_dtype=None):
    """``out = float(src) * scale`` cast to ``out_dtype`` (default: each
    leaf's dtype), with the inf/nan vote over the outputs, through
    :func:`mt_scale`; returns ``(out_tree, found_inf)``.  A ``Buckets``
    gives a ``Buckets`` of the same plan."""
    from apex_tpu_torch.optimizers.tree import tree_map

    leaves = _leaves(src)
    outs = [torch.empty_like(x, dtype=out_dtype or x.dtype) for x in leaves]
    found = mt_scale(leaves, outs, scale)
    it = iter(outs)
    return tree_map(lambda _: next(it), src), found


def multi_tensor_axpby(a, x_tree: Tree, b, y_tree: Tree, out_dtype=None):
    """``out = a*x + b*y`` elementwise over matching trees (fp32 math,
    cast to ``out_dtype`` or x's dtype), with the inf/nan vote."""
    from apex_tpu_torch.optimizers.tree import tree_map

    out = tree_map(lambda x, y: (a * x.to(torch.float32) + b * y.to(torch.float32))
                   .to(out_dtype or x.dtype), x_tree, y_tree)
    return out, tree_not_finite(out)


def multi_tensor_l2norm(tree: Tree, per_tensor: bool = False):
    """The global L2 norm over all leaves (fp32), with ``per_tensor``
    also the list of per-leaf norms, through :func:`mt_l2norm`.  On a
    ``Buckets`` the per-tensor norms are per ORIGINAL leaf."""
    views = _per_leaf_views(tree)
    if not views:
        z = torch.zeros((), dtype=torch.float32)
        return (z, []) if per_tensor else z
    total, per = mt_l2norm(views)
    if per_tensor:
        return torch.sqrt(total), list(torch.sqrt(per).unbind(0))
    return torch.sqrt(total)


def multi_tensor_norm_blend(old_norms: Sequence[torch.Tensor], tree: Tree, a: float,
                            b: float, norm_type: int = 2):
    """Blend per-leaf norms with fresh norms of ``tree``: L2 ``sqrt(a*gn^2
    + b*n^2)`` (the fresh Σx² from :func:`mt_l2norm`), L-inf ``a*gn +
    b*max|x|``.  ``old_norms`` is per original leaf."""
    views = _per_leaf_views(tree)
    if norm_type == 2:
        _, sq = mt_l2norm(views)
        return [torch.sqrt(a * torch.square(gn) + b * n2)
                for gn, n2 in zip(old_norms, sq.unbind(0))]
    if norm_type == 0:
        return [a * gn + b * torch.max(torch.abs(x.to(torch.float32)))
                for gn, x in zip(old_norms, views)]
    raise ValueError("norm_type must be 0 (L-inf) or 2 (L2)")


def tree_where(pred, true_tree: Tree, false_tree: Tree) -> Tree:
    """Leafwise ``torch.where(pred, a, b)``: the predicated commit."""
    from apex_tpu_torch.optimizers.tree import tree_map

    return tree_map(lambda t, f: torch.where(pred, t, f.to(t.dtype)), true_tree, false_tree)


__all__ = [
    "ADAM_LAUNCHES", "SCALE_LAUNCHES", "L2NORM_LAUNCHES", "REMAINDER_LAUNCHES", "MtPlan",
    "mt_plan", "sqrt_rn", "adam_core", "adam_math", "mt_adam", "mt_adam_plain", "mt_scale",
    "mt_scale_plain", "mt_adam_remainder", "mt_adam_remainder_plain", "master_from_remainder",
    "split_master",
    "mt_l2norm", "mt_l2norm_plain", "all_finite", "tree_not_finite",
    "multi_tensor_scale", "multi_tensor_axpby", "multi_tensor_l2norm",
    "multi_tensor_norm_blend", "tree_where",
]
