"""Train GPT on one device -- the port's training-step entry point.

Counterpart of the step ``bench.py`` times (``_bench_gpt_at_batch``,
bench.py:401-440) with its headline shape as the defaults: GPT-124M
(12 layers, hidden 768, 12 heads, vocab 50304, learned positions), seq
1024, batch 8, bf16 compute, flash attention, full layer remat, the
dense fp32 LM head (``fused_ce=False``); each step is the loss and its
gradients followed by ``FusedAdam(lr=3e-4, weight_decay=0.1).update``,
on the multi-tensor engine (the ``mt_adam`` kernel) as in the reference.
``--fused-ce`` takes the fused LM-head CE instead (``fused_ce=True``,
``fused_ce_chunk=128``: bench.py's ``gpt124_s1024_fce`` A/B section,
bench.py:2166-2189).  As in the JAX package, a ``--seq`` that
``--fused-ce-chunk`` does not divide takes the dense head.
Weights are random from ``--seed`` (numpy); tokens are
``np.random.RandomState(seed).randint(0, vocab, (batch, seq))`` with
targets rolled by one, the same batch every step.

    python -m apex_tpu_torch.train_gpt                    # on the GPU
    python -m apex_tpu_torch.train_gpt --device cpu --layers 2 --hidden 64 \\
        --heads 4 --vocab 128 --seq 32 --batch 2          # plain versions
    python -m apex_tpu_torch.train_gpt --fused-ce         # the fused CE head
    python -m apex_tpu_torch.train_gpt --fused-ce --fused-ce-chunk 8 --device cpu \
        --layers 2 --hidden 64 --heads 4 --vocab 128 --seq 32 --batch 2
    python -m apex_tpu_torch.train_gpt --fp16             # amp: fp16, loss scaling
    python -m apex_tpu_torch.train_gpt --fp16 --step-guard 3 --clip-grad-norm 1.0

``--fp16`` is the single-device form of ``examples/gpt/pretrain_gpt.py
--fp16``: float16 compute (fp32 params cast at use, the fp16 LayerNorm
and flash kernels) and ``DynamicLossScaler(init_scale=2**12)``, through
:func:`make_train_step`'s scaled variant: the scaled loss and its
gradients, then one fused pass of ``FusedAdam.update_scaled`` (unscale,
finite vote, the update predicated on it), the scaler's branch-free
update, and with ``--step-guard N`` a ``StepGuard(max_consecutive_bad=N)``
fed by the same vote; ``--clip-grad-norm X`` folds the global-L2 clip
into the update.  A non-finite step leaves params and optimizer state
as they were and backs the scale off, all on the device.  ``--fp16``
with ``--fused-ce`` raises: the fused-CE kernels take fp32 or bf16 x.

The step is compiled, as bench.py's ``jax.jit(..., donate_argnums=(0,
1))`` is: the loss, its gradients and the FusedAdam update, written back
into the params and the optimizer state in place, captured as one CUDA
graph (:mod:`apex_tpu_torch.graphs`; the layers' remat and the flash and
CE autograd Functions inside it).  The ``--warmup`` steps run eagerly on
a side stream and the last of them captures; every timed step is a
replay.  ``--eager`` runs the same step eagerly instead (the counterpart
of ``JAX_DISABLE_JIT=1``); on the CPU the step runs its static buffers
without capture.

Prints one JSON line: the loss of every step, the median step time
(host clock around a synchronized step), tokens/s, peak device memory
whether the step ran as a graph and the capture's host time.  The
kernel library is built before the clock starts, and the ``--warmup``
steps (the capture with them) are not timed.
"""

import argparse
import contextlib
import json
import statistics
import sys
import time

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.amp.scaler import DynamicLossScaler, all_finite
from apex_tpu_torch.graphs import CapturedStep, tensor_leaves
from apex_tpu_torch.models.gpt import GPTConfig, gpt_loss, init_params, params_from_numpy
from apex_tpu_torch.observability import stepstats
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.base import tree_leaves, tree_unflatten
from apex_tpu_torch.resilience.step_guard import StepGuard
from apex_tpu_torch.transformer.amp.grad_scaler import sync_found_inf

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: bench.py's FusedAdam weight decay
WEIGHT_DECAY = 0.1
#: ``examples/gpt/pretrain_gpt.py --fp16``'s scaler (its other settings
#: at their defaults)
FP16_INIT_SCALE = 2.0 ** 12


def build_args():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layers", type=int, default=12)
    p.add_argument("--hidden", type=int, default=768)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--vocab", type=int, default=50304)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=5, help="timed steps")
    p.add_argument("--warmup", type=int, default=1,
                   help="untimed eager steps first; the last one captures the graph")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--compute-dtype", default="bfloat16", choices=sorted(_DTYPES))
    p.add_argument("--fp16", action="store_true",
                   help="amp: float16 compute with DynamicLossScaler(init_scale=2**12), "
                        "as examples/gpt/pretrain_gpt.py --fp16 (sets --compute-dtype)")
    p.add_argument("--step-guard", type=int, default=None, metavar="N",
                   help="StepGuard(max_consecutive_bad=N) on the step's finite vote")
    p.add_argument("--clip-grad-norm", type=float, default=None, metavar="X",
                   help="fold a global-L2 grad clip to X into the optimizer's update")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fused-ce", action="store_true",
                   help="the fused LM-head cross entropy (bench.py's gpt124_s1024_fce) "
                        "in place of the dense head")
    p.add_argument("--fused-ce-chunk", type=int, default=128,
                   help="with --fused-ce: sequence positions per chunk; the fused "
                        "head runs only when --seq is a multiple (bench.py: 128)")
    p.add_argument("--eager", action="store_true",
                   help="run the step eagerly instead of as a captured CUDA graph")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu' for "
                        "the kernels' plain versions")
    return p


def compute_dtype(args) -> str:
    """The compute dtype's name: float16 with ``--fp16``."""
    return "float16" if args.fp16 else args.compute_dtype


def make_config(args) -> GPTConfig:
    """bench.py's ``GPTConfig`` for this shape."""
    return GPTConfig(
        vocab_size=args.vocab, hidden_size=args.hidden, num_layers=args.layers,
        num_attention_heads=args.heads, max_seq_len=args.seq,
        compute_dtype=torch.float16 if args.fp16 else _DTYPES[args.compute_dtype],
        use_flash_attention=True, checkpoint_layers=True, remat_policy="full",
        fused_ce=args.fused_ce, fused_ce_chunk=args.fused_ce_chunk)


def make_batch(args):
    """``(tokens, targets)`` (B, S) int64 numpy, as bench.py draws them."""
    tokens = np.random.RandomState(args.seed).randint(0, args.vocab,
                                                      size=(args.batch, args.seq))
    return tokens, np.roll(tokens, -1, axis=1)


def setup(args, params_tree=None):
    """``(config, params, tokens, targets)`` on ``args.device``: fp32
    params (``params_tree``, a numpy tree of the JAX package's layout,
    or random from ``args.seed``) and the batch."""
    dev = resolve_device(args.device)
    config = make_config(args)
    if params_tree is None:
        params = init_params(config, args.seed, dev, keep_fp32=True)
    else:
        params = params_from_numpy(params_tree, config, dev, keep_fp32=True)
    tokens, targets = make_batch(args)
    return config, params, torch.from_numpy(tokens).to(dev), torch.from_numpy(targets).to(dev)


def loss_and_grads(params, tokens, targets, config, post_loss=None, axis_name=None,
                   cp_axis=None, ep_axis=None):
    """``value_and_grad(gpt_loss)``: the loss and a tree of gradients
    shaped like ``params``; with ``post_loss`` (the loss scaler's
    ``scale``) of ``post_loss(loss)``; over the tensor-parallel group
    ``axis_name``, the context-parallel group ``cp_axis`` (then of this
    rank's local-chunk loss) and the MoE experts' group ``ep_axis`` when
    given.  Leaves that do not require a gradient yet are made to."""
    leaves = tree_leaves(params)
    for leaf in leaves:
        if not leaf.requires_grad:
            leaf.requires_grad_(True)
    loss = gpt_loss(params, tokens, targets, config, axis_name=axis_name, cp_axis=cp_axis,
                    ep_axis=ep_axis)
    if post_loss is not None:
        loss = post_loss(loss)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def _apply_scaled_update(loss_scaler, scaler_state, grads, opt, opt_state, params,
                         step_guard=None, guard_state=None, clip_grad_norm=None,
                         sync_groups=(), clip_sumsq=None, **opt_kw):
    """The JAX package's ``_apply_scaled_update`` (apex_tpu/models/gpt.py):
    unscale, the finite vote (``sync_found_inf`` over ``sync_groups``,
    the model-parallel groups; with none, the vote as it is), the update
    predicated on it, the scaler's update; with ``step_guard`` the same
    vote feeds the guard.  An engine optimizer does the first three in
    its one fused pass (``update_scaled``, the clip folded in, its Σx²
    agreed by ``clip_sumsq``); any other takes the explicit unscale,
    vote and ``update(grads_finite=)``.  ``opt_kw`` (``presynced``,
    ``inplace``) goes to the engine optimizer's call.
    Returns ``(params, state, scaler_state[, guard_state])``."""
    def vote(f):
        return sync_found_inf(f, sync_groups)

    if getattr(opt, "supports_update_scaled", False):
        new_params, new_state, finite = opt.update_scaled(
            grads, opt_state, params, scale=scaler_state.loss_scale, clip_norm=clip_grad_norm,
            finite_sync=vote, sumsq_reduce=clip_sumsq, **opt_kw)
    else:
        grads, finite = loss_scaler.unscale(scaler_state, grads)
        finite = vote(finite)
        new_params, new_state = opt.update(grads, opt_state, params, grads_finite=finite)
    stepstats.offer("all_finite", finite)
    new_scaler = loss_scaler.update(scaler_state, finite)
    if step_guard is None:
        return new_params, new_state, new_scaler
    return new_params, new_state, new_scaler, step_guard.update(guard_state, finite)


def _apply_guarded_update(grads, opt, opt_state, params, step_guard, guard_state,
                          clip_grad_norm=None, sync_groups=(), clip_sumsq=None, **opt_kw):
    """The JAX package's ``_apply_guarded_update``: no loss scale; the
    finite vote (agreed over ``sync_groups``) alone predicates the update
    and feeds the guard (an engine optimizer votes in its fused pass,
    ``scale=None``; ``opt_kw`` as :func:`_apply_scaled_update`).
    Returns ``(params, state, guard_state)``."""
    def vote(f):
        return sync_found_inf(f, sync_groups)

    if getattr(opt, "supports_update_scaled", False):
        new_params, new_state, finite = opt.update_scaled(
            grads, opt_state, params, clip_norm=clip_grad_norm, finite_sync=vote,
            sumsq_reduce=clip_sumsq, **opt_kw)
    else:
        finite = vote(all_finite(grads))
        new_params, new_state = opt.update(grads, opt_state, params, grads_finite=finite)
    stepstats.offer("all_finite", finite)
    return new_params, new_state, step_guard.update(guard_state, finite)


def _check_zero_axis(opt, dp_group):
    """The JAX package's ``_check_zero_axis``: a ZeRO optimizer syncs over
    its own dp group (or its hierarchical ``dp_axes`` split), and the
    step keys its grad calculus on ``dp_group``; a mismatch would un- or
    double-sync the grads, so it raises when the step is built.  A
    hierarchical ``dp_group`` (a tuple of hop groups, slow to fast) needs
    an optimizer with the same ``dp_axes``, and a hierarchical optimizer
    refuses a flat group.  No check without a ``dp_group`` (the optimizer
    owns its group)."""
    if not hasattr(opt, "sharded_state_dict") or dp_group is None:
        return
    opt_axes = getattr(opt, "dp_axes", None)
    if isinstance(dp_group, (tuple, list)):
        axes = tuple(str(g) for g in dp_group)
        if opt_axes is None or tuple(opt_axes) != axes:
            have = tuple(opt_axes) if opt_axes is not None else opt.axis_name
            raise ValueError(f"the train step's dp axis is the hierarchical split {axes!r} but "
                             f"the ZeRO optimizer syncs over {have!r}; construct it with "
                             f"dp_axes={axes!r} (the optimizer owns both hops of the grad "
                             "sync)")
        return
    if opt_axes is not None:
        raise ValueError(f"ZeRO optimizer was built for the hierarchical dp split "
                         f"{tuple(opt_axes)!r} but the train step's dp group is the flat "
                         f"{str(dp_group)!r}; pass the hop groups as dp_group (or drop the "
                         "optimizer's dp_axes)")
    if isinstance(dp_group, str) and str(dp_group) != opt.axis_name:
        raise ValueError(f"ZeRO optimizer shards over axis {opt.axis_name!r} but the train "
                         f"step's dp group is {str(dp_group)!r}")


def _flat_dp_group(dp_group):
    """The flat data-parallel group of the same ranks as the hop groups
    of a hierarchical ``dp_group`` (checked: the hops' sizes multiply to
    its size and their ranks lie in it)."""
    from apex_tpu_torch.transformer import parallel_state as ps

    flat, covered = ps.get_data_parallel_group(), 1
    for g in dp_group:
        covered *= g.size()
    if covered != flat.size() or any(not set(g.ranks) <= set(flat.ranks) for g in dp_group):
        raise ValueError(f"the hop groups {tuple(str(g) for g in dp_group)!r} do not split "
                         f"this rank's data-parallel group of {flat.size()} ranks")
    return flat


def _quantized_wire(dp_group, qspec):
    """``(tree_sync, bucket_sync, world)`` of the replicated quantized dp
    sync over the flat ``dp_group``
    (:func:`~apex_tpu_torch.contrib.optimizers._quantized_sync.quantized_pmean`
    of a grad tree, ``quantized_pmean_bucket`` of one packed fp32
    bucket), or over a hierarchical one the multi-hop forms
    (``_hierarchical_sync.quantized_multi_hop_pmean`` and ``_bucket``,
    the plan from the hop groups' sizes); ``world`` pads the plan."""
    from apex_tpu_torch.contrib.optimizers import _hierarchical_sync as hs
    from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
    from apex_tpu_torch.parallel.distributed import process_group

    if isinstance(dp_group, (tuple, list)):
        _flat_dp_group(dp_group)
        plan = hs.hierarchical_plan(tuple(str(g) for g in dp_group),
                                    {str(g): g.size() for g in dp_group},
                                    grad_wire_dtype=qspec.name, groups=tuple(dp_group))
        return (lambda g: hs.quantized_multi_hop_pmean(g, plan, qspec),
                lambda h: hs.quantized_multi_hop_pmean_bucket(h, plan, qspec), plan.world)
    pg, world = process_group(dp_group)
    return (lambda g: qs.quantized_pmean(g, pg, qspec, world),
            lambda h: qs.quantized_pmean_bucket(h, pg, qspec, world), world)


def _expert_split_sync(sync, world):
    """``sync`` (a tree's DDP all-reduce) over every leaf but the MoE
    experts', which are dp-split sums (the exchange already brought every
    rank's cotangents to their owner): those are scaled by 1 / ``world``
    instead, the JAX step's ``pmean_grads(skip_experts=True)``."""
    from apex_tpu_torch.transformer.expert_parallel import EXPERT_PARAM_KEYS

    inv = 1.0 / world

    def grad_sync(grads):
        moe = grads["layers"]["moe"]
        rest = {**grads, "layers": {**grads["layers"], "moe": {
            k: v for k, v in moe.items() if k not in EXPERT_PARAM_KEYS}}}
        rest = sync(rest)
        rest["layers"]["moe"] = {k: v * inv if k in EXPERT_PARAM_KEYS
                                 else rest["layers"]["moe"][k] for k, v in moe.items()}
        return rest

    return grad_sync


def _dp_sync(opt, dp_group, qspec=None, expert_grads=False):
    """``(grad sync or None, loss mean or None)`` of a step: a ZeRO
    optimizer owns the grad sync (its reduce-scatter), so the step only
    averages the loss over its group; a replicated optimizer with
    ``qspec`` (``grad_sync_dtype``) gets the quantized all-reduce a
    bucket (:func:`_quantized_wire`: flat, or multi-hop over a
    hierarchical ``dp_group``); otherwise one over a ``dp_group`` of more
    than one rank gets the DDP all-reduce
    (:func:`apex_tpu_torch.parallel.allreduce_gradients`); either gets
    the loss mean.  The loss mean adds in rank order, the JAX step's
    ``pmean``.  A hierarchical ``dp_group`` with a replicated wide sync
    syncs over the flat data-parallel group of the same ranks, as the
    JAX step's one ``pmean`` over both axes does.  With ``expert_grads``
    (MoE, whose experts split over ``dp_group``) the all-reduce skips the
    expert leaves and scales them by 1 / dp (:func:`_expert_split_sync`)."""
    from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
    from apex_tpu_torch.parallel.distributed import allreduce_gradients, process_group

    if hasattr(opt, "sharded_state_dict"):
        pg, world = opt._pg, opt.world_size
        grad_sync = None
    elif qspec is not None:
        grad_sync = _quantized_wire(dp_group, qspec)[0]
        flat = _flat_dp_group(dp_group) if isinstance(dp_group, (tuple, list)) else dp_group
        pg, world = process_group(flat)
    elif isinstance(dp_group, (tuple, list)):
        return _dp_sync(opt, _flat_dp_group(dp_group))
    elif dp_group is not None and process_group(dp_group)[1] > 1:
        pg, world = process_group(dp_group)

        def grad_sync(grads):
            return allreduce_gradients(grads, group=dp_group)
        if expert_grads:
            grad_sync = _expert_split_sync(grad_sync, world)
    else:
        return None, None

    def loss_mean(loss):
        return qs.rank_order_sum(loss.reshape(1), pg, world)[0] / world

    return grad_sync, loss_mean


def _check_grad_sync_dtype(opt, dp_group, grad_sync_dtype, moe=False):
    """The JAX step's checks of its ``grad_sync_dtype`` knob; returns its
    :class:`~apex_tpu_torch.contrib.optimizers._quantized_sync.QSpec` (or
    None without the knob)."""
    from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs

    if grad_sync_dtype is None:
        return None
    qspec = qs.qspec_of(grad_sync_dtype)
    if qspec is None:
        raise ValueError(
            f"grad_sync_dtype={qs._name(grad_sync_dtype)!r}: the step builder's knob quantizes "
            "the replicated dp sync and accepts int8/float8_e4m3fn/float8_e5m2 only (wide "
            "sync dtypes belong to the ZeRO optimizer's own knob)")
    if hasattr(opt, "sharded_state_dict"):
        raise ValueError(
            "a ZeRO optimizer owns the dp grad sync: pass grad_sync_dtype to its constructor "
            "(where it gains the error-feedback residual), not to make_train_step")
    if moe:
        raise NotImplementedError("quantized dp sync + MoE is not wired: expert grads are "
                                  "dp-sharded sums, not pmean'd")
    if dp_group is None:
        raise ValueError("grad_sync_dtype quantizes the dp sync; this step has dp_axis=None")
    return qspec


def _check_overlap(opt, config, dp_group, qspec, cp=None):
    """The JAX step's refusals of ``overlap_grad_sync`` (its messages)."""
    for bad, why in (
            (config.moe_num_experts > 0, "MoE (expert grads are dp-sharded sums, not "
                                         "bucketed pmean wires)"),
            (config.sequence_parallel, "sequence parallelism (sp_grad_sync is a whole-tree "
                                       "pass after the backward)"),
            (cp is not None, "context parallelism (cp grads need a second pmean after the "
                             "backward)")):
        if bad:
            raise NotImplementedError(f"overlap_grad_sync is not wired for {why}")
    if dp_group is None:
        raise ValueError("overlap_grad_sync overlaps the dp grad sync; this step has "
                         "dp_axis=None")
    if not hasattr(opt, "sharded_state_dict") and qspec is None:
        raise ValueError(
            "overlap_grad_sync needs a per-bucket dp grad sync to overlap — a ZeRO optimizer "
            "(each bucket's reduce-scatter issues as its grads materialize) or "
            "grad_sync_dtype= (per-bucket quantized pmean); the plain replicated pmean is "
            "one whole-tree sweep with nothing to interleave")


#: each device's communication stream of the overlapped grad sync
_COMM_STREAMS = {}


class _CommStream:
    """Where the overlapped step runs its bucket wires: on CUDA one
    stream a device, forked from the current stream after a stage's
    backward (:meth:`fork`: it waits for what the current stream has
    queued, the grads it packs included) and joined before the update
    reads the shards (:meth:`join`), both by events, so a capture takes
    them in; on the CPU the current thread, in order."""

    def __init__(self, device):
        self.stream = None
        if device.type == "cuda":
            if device not in _COMM_STREAMS:
                _COMM_STREAMS[device] = torch.cuda.Stream(device)
            self.stream = _COMM_STREAMS[device]

    @contextlib.contextmanager
    def fork(self):
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.stream.device))
        with torch.cuda.stream(self.stream):
            yield

    def join(self):
        if self.stream is not None:
            torch.cuda.current_stream(self.stream.device).wait_stream(self.stream)


def overlap_value_and_grads(opt, config, params, state, tokens, targets, post, scale,
                            tp=None, wire=None):
    """The backward-overlapped twin of :func:`loss_and_grads`, the JAX
    package's ``overlap_value_and_grads``: the forward runs as the three
    segments of :mod:`apex_tpu_torch.models.gpt` with their boundary
    activations detached, and the backward as three
    ``torch.autograd.grad`` calls, head first.  After each, every bucket
    whose leaves all have their grads (``bucketing.buckets_by_stage``
    over ``_OVERLAP_STAGES``: the final LayerNorm's after the head, the
    stacked layers' after the layers, the embedding and positions after
    the embedding, the tied embedding's two halves added) has its wire
    run on the communication stream (:class:`_CommStream`) while the
    next backward runs on the current stream, which joins the
    communication stream once, before the update.

    With a ZeRO optimizer the wire is its ``bucket_grad_issue`` (with
    ``scale`` and the bucket's residual from ``state``), finished once
    the next bucket's has started, and the result
    ``(loss, None, presynced)`` hands the shards, new residuals and
    pre-wire buckets to its ``update``; with a replicated optimizer
    ``wire`` is :func:`_quantized_wire`'s ``(tree_sync, bucket_sync,
    world)`` and the result ``(loss, grads, None)`` the synced, still
    scaled, grads.
    Every bucket's calls are the unoverlapped step's on the same values,
    so fp32 losses and params are bitwise that step's."""
    from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
    from apex_tpu_torch.models.gpt import (
        _OVERLAP_STAGES, _embed_segment, _head_segment, _layers_segment, lm_head_loss,
    )
    from apex_tpu_torch.optimizers import bucketing

    unknown = sorted(set(params) - set(_OVERLAP_STAGES))
    if unknown:
        raise NotImplementedError(f"overlap_grad_sync does not know the gradient-readiness "
                                  f"stage of param group(s) {unknown}")
    leaves = tree_leaves(params)
    for leaf in leaves:
        if not leaf.requires_grad:
            leaf.requires_grad_(True)
    dev = params["embed"].device
    t = torch.as_tensor(targets, device=dev).transpose(0, 1)  # (S, B)
    embed, pos = params["embed"], params.get("pos_embed")
    ln_s, ln_b = params["final_ln_scale"], params["final_ln_bias"]
    layer_leaves = tree_leaves(params["layers"])

    x0 = _embed_segment(embed, pos, tokens, config, tp)
    x0_in = x0.detach().requires_grad_(True)
    x1 = _layers_segment(params["layers"], x0_in, config, tp)[0]
    x1_in = x1.detach().requires_grad_(True)
    h = _head_segment(x1_in, ln_s, ln_b, config, tp)
    loss = lm_head_loss(h, embed, t, config, tp).mean()
    scaled = loss if post is None else post(loss)

    idx = tree_unflatten(params, list(range(len(leaves))))
    stages = [0] * len(leaves)
    for key, sub in idx.items():
        for li in tree_leaves(sub):
            stages[li] = _OVERLAP_STAGES[key]
    cot = [None] * len(leaves)

    def fill(key, vals):
        for li, v in zip(tree_leaves(idx[key]), vals, strict=True):
            cot[li] = v

    zero = hasattr(opt, "sharded_state_dict")
    if zero:
        plan = opt._plan_of_local(params)
    else:
        _, bucket_sync, world = wire
        plan = bucketing.plan_of(params, shard_pad=world, block=qs.QBLOCK)
    by_stage = bucketing.buckets_by_stage(plan, stages, 3)
    synced, pending = [None] * len(plan.buckets), []
    comm = _CommStream(dev)

    def finish(keep):
        while len(pending) > keep:
            bi, wire = pending.pop(0)
            synced[bi] = wire.finish()

    def issue(stage):
        # a ZeRO bucket's wire finishes once the next one has started: its
        # collective runs while the next bucket packs, and at most two
        # buckets' temporaries are alive
        with comm.fork():
            for bi in by_stage[stage]:
                if zero:
                    res = state.residual[bi] if opt._quantized else None
                    pending.append((bi, opt.bucket_grad_issue(bi, cot, scale=scale,
                                                              residual=res)))
                    finish(1)
                else:
                    synced[bi] = bucket_sync(
                        bucketing.pack_bucket(plan.buckets[bi], cot, torch.float32))

    d_ln_s, d_ln_b, d_embed_head, d_x1 = torch.autograd.grad(scaled, [ln_s, ln_b, embed, x1_in])
    fill("final_ln_scale", [d_ln_s])
    fill("final_ln_bias", [d_ln_b])
    issue(0)
    *d_layers, d_x0 = torch.autograd.grad(x1, layer_leaves + [x0_in], grad_outputs=d_x1)
    fill("layers", d_layers)
    issue(1)
    if pos is not None:
        d_embed_lookup, d_pos = torch.autograd.grad(x0, [embed, pos], grad_outputs=d_x0)
        fill("pos_embed", [d_pos])
    else:
        (d_embed_lookup,) = torch.autograd.grad(x0, [embed], grad_outputs=d_x0)
    fill("embed", [d_embed_head + d_embed_lookup])
    issue(2)
    with comm.fork():
        finish(0)
    comm.join()
    if zero:
        return scaled.detach(), None, tuple(tuple(d[i] for d in synced) for i in range(3))
    return scaled.detach(), bucketing.unpack(plan, synced), None


def make_train_step(opt, config, loss_scaler=None, step_guard=None, clip_grad_norm=None,
                    graphs=None, warmup=1, telemetry=None, dp_group=None,
                    overlap_grad_sync=False, tp_group=None, chaos=None, grad_sync_dtype=None,
                    inplace_update=True, cp_group=None):
    """The single-device form of the JAX package's ``make_train_step``
    (apex_tpu/models/gpt.py): ``step(params, state, [scaler_state],
    [guard_state], [stats], tokens, targets) -> loss``, a scaler state
    only with ``loss_scaler``, a guard state only with ``step_guard`` and
    a :class:`~apex_tpu_torch.observability.StepStats` window only with
    ``telemetry`` (a :class:`~apex_tpu_torch.observability.StepTelemetry`),
    as the JAX step's variants take them.  The window is updated in place
    (:meth:`StepTelemetry.accumulate_`) from the loss, the grad norm and
    finite vote the update offers through the capture seam, the new loss
    scale and the param/update norms; it observes and changes nothing
    else, so losses and params are bitwise those of the step without it.

    The step is the loss (scaled by ``loss_scaler``) and its gradients,
    then the update: :func:`_apply_scaled_update` with a scaler,
    :func:`_apply_guarded_update` with a guard alone, else
    ``opt.update`` (``clip_grad_norm`` folded into each; it needs an
    engine optimizer).  The params, optimizer state and small states are
    updated in place, the counterpart of donating them: an optimizer with
    ``supports_inplace`` (the engine optimizers, ZeRO) writes them itself
    (``update(..., inplace=True)``; FusedAdam's ``mt_adam`` over the
    tensors it reads), and the rest is copied in.  ``inplace_update=
    False``, or a ``telemetry`` window (whose update norm reads the old
    params), takes the copying step: the optimizer's new tensors copied
    into the given ones, bitwise the same values.  The loss returned is
    the unscaled one.  Compiled unless
    ``graphs=False``: a :class:`~apex_tpu_torch.graphs.CapturedStep` that
    runs ``warmup`` eager steps on a side stream, captures the step as one
    CUDA graph after the last of them, and replays it; on the CPU it runs
    the static buffers without capture.  Nothing in the step reads a
    device value on the host.  ``params`` must already require gradients
    when captured.

    Data parallelism: a ZeRO optimizer
    (:mod:`apex_tpu_torch.contrib.optimizers`) owns the grad sync over
    its group and the step adds none; a replicated optimizer gets the
    DDP all-reduce of the grads over ``dp_group`` (an ``AxisGroup``)
    when it has more than one rank.  ``dp_group`` may be a hierarchical
    split, the tuple of its hop groups slow to fast
    (``parallel_state.get_data_parallel_hop_groups``): a ZeRO optimizer
    must then have the same ``dp_axes`` (``_check_zero_axis``), and a
    replicated one syncs over the flat data-parallel group.  Either
    way the loss returned is the mean over the group, as the JAX step's
    ``pmean``.  The collectives are captured with the rest of the step.

    ``grad_sync_dtype`` (int8, float8_e4m3fn or float8_e5m2) quantizes a
    replicated optimizer's dp sync: each bucket's all-reduce becomes a
    reduce-scatter and all-gather on the wire dtype with shared block
    scales and no residual (``quantized_pmean``; over a hierarchical
    ``dp_group`` the multi-hop ``quantized_multi_hop_pmean``).  It raises
    with a ZeRO optimizer (which takes the knob itself) and without a
    dp group, as the JAX step does.

    ``overlap_grad_sync=True`` issues each bucket's sync inside the
    backward (:func:`overlap_value_and_grads`): the ZeRO optimizer's
    reduce-scatter, or with ``grad_sync_dtype`` the quantized all-reduce,
    on a communication stream between the three segment backwards; fp32
    losses and params are bitwise the unoverlapped step's.  As in the
    JAX package it raises under sequence parallelism
    (``NotImplementedError``), without a dp group, and with a replicated
    optimizer without ``grad_sync_dtype`` (the plain all-reduce has no
    per-bucket wire).

    Tensor parallelism: with ``tp_group`` (an ``AxisGroup`` of more than
    one rank; ``params`` and ``state`` this rank's shards of
    :func:`~apex_tpu_torch.models.gpt.param_specs`) the loss and its
    gradients run over the group (:func:`~apex_tpu_torch.models.gpt.
    gpt_loss` with ``axis_name``); with ``config.sequence_parallel`` the
    LN and row-bias grads are then summed over it (``sp_grad_sync``); a
    clip's Σx² sums the split leaves over the group and the replicated
    ones not (``clip_sumsq_reduce``); the finite vote is agreed over it,
    and the telemetry's norms are those of the whole model (the clip's
    reduce).  The dp sync and the loss mean stay on ``dp_group``.  A
    ZeRO optimizer then holds the dp shard of this rank's tp slice
    (``init(params, param_specs=param_specs(config), axis_sizes={"tp":
    N})``); its reduce-scatter is the dp sync and its vote covers dp.

    Context parallelism: with ``cp_group`` (the context-parallel
    ``AxisGroup``, the JAX step's ``cp_axis``) ``tokens`` and ``targets``
    are this rank's sequence chunk, the loss and its gradients are those
    of :func:`~apex_tpu_torch.models.gpt.gpt_loss` with ``cp_axis`` (ring
    attention over the group), and both are averaged over the group
    before the dp sync (``sync_loss_and_grads``: cp acts as a data axis
    for the grads); a ZeRO optimizer's reduce-scatter then stays the dp
    half.  A one-rank group still runs the ring.  It raises with
    sequence parallelism (ValueError) and with ``overlap_grad_sync``
    (NotImplementedError), as the JAX step does.

    ``chaos``: a :class:`~apex_tpu_torch.resilience.chaos.ChaosMonkey`
    whose planned NaN steps poison the guarded step's gradients (it needs
    ``step_guard``, whose device step counter keys the plan): the loss is
    multiplied by :meth:`~apex_tpu_torch.resilience.chaos.ChaosMonkey
    .grad_fault` before the backward, on the device, so a captured step
    replays the plan with no host read; the guard then skips the step.

    Mixture of experts (``config.moe_num_experts`` > 0): the experts ride
    ``dp_group`` (the JAX step's ``ep_axis = dp_axis``), each rank holding
    its E / dp (``shard_params(..., ep_group=dp_group)``) and exchanging
    tokens over the group twice a layer; the loss adds ``moe_aux_coef``
    times the aux; the expert grads skip the DDP all-reduce and are
    scaled by 1 / dp (the router and every other leaf are averaged as
    always); dp joins the finite vote; a clip's Σx² sums the expert
    leaves over dp.  Tensor and context parallelism compose.  As in the
    JAX step it raises ValueError when the experts do not divide over dp,
    and NotImplementedError with a hierarchical ``dp_group``, with
    ``grad_sync_dtype``, with a ZeRO optimizer and with
    ``overlap_grad_sync``."""
    from apex_tpu_torch.models.gpt import (
        _check_cp, _cp, _tp, check_ep, check_tp, clip_sumsq_reduce,
    )

    if config.moe and isinstance(dp_group, (tuple, list)):
        raise NotImplementedError("MoE expert parallelism over a hierarchical dp split is not "
                                  "wired (EP rides a single dp axis)")
    ep = dp_group if config.moe else None  # EP rides DP
    if ep is not None:
        check_ep(config, ep.size(), str(ep))
    cp = _cp(cp_group)
    _check_cp(config, cp)
    qspec = _check_grad_sync_dtype(opt, dp_group, grad_sync_dtype, config.moe)
    if config.moe and hasattr(opt, "sharded_state_dict"):
        raise NotImplementedError("ZeRO + MoE expert sharding both claim the dp axis; not wired")
    _check_zero_axis(opt, dp_group)
    if overlap_grad_sync:
        _check_overlap(opt, config, dp_group, qspec, cp)
    tp = _tp(tp_group)
    if tp is not None:
        check_tp(config, tp.size())
    split = tp is not None or ep is not None
    norm_sumsq = clip_sumsq_reduce(config, tp, ep_group=ep) if split else None
    clip_sumsq = norm_sumsq if clip_grad_norm is not None else None
    # tp-split grads, and the dp-split expert grads, can overflow on one
    # rank only: each such group joins the finite vote
    sync_groups = tuple(g for g in (tp, ep) if g is not None and g.size() > 1)

    def grads_fn(params, tokens, targets, post):
        return loss_and_grads(params, tokens, targets, config, post, axis_name=tp, cp_axis=cp,
                              ep_axis=ep)

    overlap = None
    if overlap_grad_sync:
        wire = None if hasattr(opt, "sharded_state_dict") else _quantized_wire(dp_group, qspec)

        def overlap(params, state, tokens, targets, post, scale):
            return overlap_value_and_grads(opt, config, params, state, tokens, targets, post,
                                           scale, tp=tp, wire=wire)

    return _make_step(opt, config, grads_fn, loss_scaler=loss_scaler, step_guard=step_guard,
                      clip_grad_norm=clip_grad_norm, graphs=graphs, warmup=warmup,
                      telemetry=telemetry, dp_group=dp_group, tp_group=tp,
                      sync_groups=sync_groups, clip_sumsq=clip_sumsq, norm_sumsq=norm_sumsq,
                      chaos=chaos, qspec=qspec, overlap=overlap, inplace_update=inplace_update,
                      cp_group=cp, expert_grads=ep is not None)


def _cp_sync(cp):
    """``(loss, grads) -> (loss, grads)`` averaged over the context-parallel
    group ``cp`` (the JAX steps' ``pmean`` over cp: each rank's loss and
    grads are those of its local chunk), or None for no group or one of
    one rank.  The loss adds in rank order, the grads by the DDP
    all-reduce a bucket."""
    if cp is None or cp.size() == 1:
        return None
    from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
    from apex_tpu_torch.parallel.distributed import allreduce_gradients

    def sync(loss, grads):
        loss = qs.rank_order_sum(loss.reshape(1), cp.group, cp.size())[0] / cp.size()
        return loss, allreduce_gradients(grads, group=cp)

    return sync


def _post_loss(loss_scaler, scaler_state, fault):
    """What the step applies to the loss before its backward: the chaos
    ``fault`` (NaN or 1) and then the loss scale, as the JAX steps'
    ``post_loss``; None when neither is there."""
    if loss_scaler is None and fault is None:
        return None

    def post(loss):
        if fault is not None:
            loss = loss * fault
        return loss if loss_scaler is None else loss_scaler.scale(scaler_state, loss)

    return post


def _make_step(opt, config, grads_fn, *, loss_scaler=None, step_guard=None,
               clip_grad_norm=None, graphs=None, warmup=1, telemetry=None, dp_group=None,
               tp_group=None, sync_groups=(), clip_sumsq=None, norm_sumsq=None, chaos=None,
               qspec=None, overlap=None, inplace_update=True, cp_group=None,
               expert_grads=False):
    """The step that :func:`make_train_step` and
    :func:`apex_tpu_torch.models.gpt.make_pp_train_step`, and the T5
    steps of :mod:`apex_tpu_torch.models.t5`): ``grads_fn(params, *data,
    post_loss) -> (loss, grads)``, ``data`` the step's batch arguments
    (``tokens, targets``; T5's ``src, dec_in, targets``), gives the
    (scaled) loss and this rank's grads; then the sequence-parallel sum
    over ``tp_group``, the dp sync over ``dp_group``, the update (the
    finite vote agreed over ``sync_groups``, the clip's Σx² by
    ``clip_sumsq``), the telemetry window (its norms reduced by
    ``norm_sumsq`` when the params are slices) and the loss mean over
    dp; the loss and grads averaged over ``cp_group`` (context
    parallelism) before the dp sync; compiled unless ``graphs=False``.
    ``chaos`` scales the loss by its planned fault before the scaler
    (the JAX steps' ``post_loss``).
    ``qspec``: the replicated dp sync's quantized wire; ``overlap(params,
    state, tokens, targets, post_loss, scale) -> (loss, grads,
    presynced)`` replaces ``grads_fn`` and the dp sync (the overlapped
    backward); ``inplace_update`` lets an optimizer that supports it
    write the params and state itself; ``expert_grads``: the MoE experts
    split over ``dp_group``, whose grads skip its all-reduce.  See
    :func:`make_train_step`."""
    from apex_tpu_torch.models.gpt import sp_grad_sync

    if chaos is not None and step_guard is None:
        raise ValueError("chaos NaN injection needs step_guard (the injection step counter "
                         "lives in GuardState)")
    grad_sync, loss_mean = _dp_sync(opt, dp_group, qspec, expert_grads)
    cp_sync = _cp_sync(cp_group)
    inplace = (inplace_update and telemetry is None
               and getattr(opt, "supports_inplace", False))
    if clip_grad_norm is not None and not getattr(opt, "supports_update_scaled", False):
        raise ValueError("clip_grad_norm needs an engine optimizer (OptimizerBase "
                         "subclass): the clip folds into its fused grad pass")
    n_small = int(loss_scaler is not None) + int(step_guard is not None)
    n_state = n_small + int(telemetry is not None)

    def step(params, state, *rest):
        small, data = rest[:n_small], rest[n_state:]
        if telemetry is None:
            loss, new = body(params, state, small, data)
        else:
            with stepstats.capture(norm_sumsq) as cap:
                loss, new = body(params, state, small, data)
            telemetry.accumulate_(
                rest[n_small], loss=loss, grad_norm=cap.get("grad_norm"),
                finite=cap.get("all_finite"),
                loss_scale=new[2].loss_scale if loss_scaler is not None else None,
                new_params=new[0], old_params=params, sumsq_reduce=norm_sumsq)
        with torch.no_grad():
            for dst, src in zip(tensor_leaves((params, state, *small)), tensor_leaves(new),
                                strict=True):
                if dst is not src:
                    dst.copy_(src)
        return loss

    def body(params, state, small, data):
        """``(loss, (params, state, *small states))`` of one step on the
        batch ``data`` (``(tokens, targets)``, or the step's own)."""
        scaler_state = small[0] if loss_scaler is not None else None
        guard_state = small[-1] if step_guard is not None else None
        fault = chaos.grad_fault(guard_state.step) if chaos is not None else None
        post = _post_loss(loss_scaler, scaler_state, fault)
        kw = {"inplace": True} if inplace else {}
        if overlap is not None:
            scale = scaler_state.loss_scale if loss_scaler is not None else None
            loss, grads, presynced = overlap(params, state, *data, post, scale)
            if presynced is not None:
                kw["presynced"] = presynced
        else:
            loss, grads = grads_fn(params, *data, post)
            if getattr(config, "sequence_parallel", False):
                grads = sp_grad_sync(grads, tp_group)
            if cp_sync is not None:
                loss, grads = cp_sync(loss, grads)
            if grad_sync is not None:
                grads = grad_sync(grads)
        if loss_scaler is not None:
            loss = loss / scaler_state.loss_scale
            new = _apply_scaled_update(loss_scaler, scaler_state, grads, opt, state, params,
                                       step_guard=step_guard, guard_state=guard_state,
                                       clip_grad_norm=clip_grad_norm, sync_groups=sync_groups,
                                       clip_sumsq=clip_sumsq, **kw)
        elif step_guard is not None:
            new = _apply_guarded_update(grads, opt, state, params, step_guard, guard_state,
                                        clip_grad_norm=clip_grad_norm, sync_groups=sync_groups,
                                        clip_sumsq=clip_sumsq, **kw)
        elif clip_grad_norm is not None:
            new = opt.update(grads, state, params, clip_norm=clip_grad_norm,
                             sumsq_reduce=clip_sumsq, **kw)
        else:
            new = opt.update(grads, state, params, **kw)
        if loss_mean is not None:
            loss = loss_mean(loss)
        return loss, new

    if graphs is False:
        return step
    return CapturedStep(step, donate=range(2 + n_state), warmup=warmup)


def run(args, params_tree=None, opt=None, loss_scaler=None, step_guard=None):
    """Train ``args.warmup + args.steps`` steps; returns ``(report,
    params, state)``.  ``opt``: the optimizer, by default bench.py's
    ``FusedAdam(lr=args.lr, weight_decay=0.1)`` on the multi-tensor
    engine.  ``loss_scaler``: by default ``DynamicLossScaler(init_scale=
    2**12)`` with ``--fp16`` and none without; ``step_guard``: by default
    ``StepGuard(args.step_guard)`` when that is given.  With a guard,
    ``StepGuard.check`` runs on the host after the last step."""
    config, params, tokens, targets = setup(args, params_tree)
    dev = tokens.device
    cuda = dev.type == "cuda"
    if cuda:
        from apex_tpu_torch.ops import _build

        _build.load()
        torch.cuda.reset_peak_memory_stats(dev)
    if opt is None:
        opt = FusedAdam(lr=args.lr, weight_decay=WEIGHT_DECAY)
    if loss_scaler is None and args.fp16:
        loss_scaler = DynamicLossScaler(init_scale=FP16_INIT_SCALE)
    if step_guard is None and args.step_guard is not None:
        step_guard = StepGuard(max_consecutive_bad=args.step_guard)
    state = opt.init(params)
    small = [] if loss_scaler is None else [loss_scaler.init(dev)]
    small += [] if step_guard is None else [step_guard.init(dev)]
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    step = make_train_step(opt, config, loss_scaler=loss_scaler, step_guard=step_guard,
                           clip_grad_norm=args.clip_grad_norm,
                           graphs=False if args.eager else None, warmup=args.warmup)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    losses, times, scales = [], [], []
    for i in range(args.warmup + args.steps):
        sync()
        t0 = time.perf_counter()
        loss = step(params, state, *small, tokens, targets)
        sync()
        if i >= args.warmup:
            times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if loss_scaler is not None:
            scales.append(float(small[0].loss_scale))
    n = args.warmup + args.steps
    step_s = statistics.median(times) if times else None
    report = {
        "optimizer": "engine" if opt.use_buckets else "per_leaf",
        "model": {"layers": args.layers, "hidden": args.hidden, "heads": args.heads,
                  "vocab": args.vocab, "seq": args.seq, "batch": args.batch,
                  "fused_ce": args.fused_ce, "fused_ce_chunk": args.fused_ce_chunk},
        "compute_dtype": compute_dtype(args),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "warmup_steps": args.warmup,
        "losses": losses,
        # the scale after each step, the state the next step reads
        "loss_scale": scales if loss_scaler is not None else None,
        # steps whose update the finite vote held back (the optimizer's
        # step counter did not move)
        "skipped_steps": n - int(state.step),
        "step_guard": None if step_guard is None else step_guard.state_dict(small[-1]),
        "clip_grad_norm": args.clip_grad_norm,
        "step_ms": [1e3 * t for t in times],
        "step_ms_median": None if step_s is None else 1e3 * step_s,
        "tokens_per_sec": None if step_s is None else args.batch * args.seq / step_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
        "graphs": isinstance(step, CapturedStep) and step.graph is not None,
        "capture_ms": 1e3 * step.capture_seconds if isinstance(step, CapturedStep) else 0.0,
    }
    if step_guard is not None:
        step_guard.check(small[-1])
    return report, params, state


def main(argv=None):
    args = build_args().parse_args(argv)
    report = run(args)[0]
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
