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


def loss_and_grads(params, tokens, targets, config, post_loss=None, axis_name=None):
    """``value_and_grad(gpt_loss)``: the loss and a tree of gradients
    shaped like ``params``; with ``post_loss`` (the loss scaler's
    ``scale``) of ``post_loss(loss)``; over the tensor-parallel group
    ``axis_name`` when given.  Leaves that do not require a gradient yet
    are made to."""
    leaves = tree_leaves(params)
    for leaf in leaves:
        if not leaf.requires_grad:
            leaf.requires_grad_(True)
    loss = gpt_loss(params, tokens, targets, config, axis_name=axis_name)
    if post_loss is not None:
        loss = post_loss(loss)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def _apply_scaled_update(loss_scaler, scaler_state, grads, opt, opt_state, params,
                         step_guard=None, guard_state=None, clip_grad_norm=None,
                         sync_groups=(), clip_sumsq=None):
    """The JAX package's ``_apply_scaled_update`` (apex_tpu/models/gpt.py):
    unscale, the finite vote (``sync_found_inf`` over ``sync_groups``,
    the model-parallel groups; with none, the vote as it is), the update
    predicated on it, the scaler's update; with ``step_guard`` the same
    vote feeds the guard.  An engine optimizer does the first three in
    its one fused pass (``update_scaled``, the clip folded in, its Σx²
    agreed by ``clip_sumsq``); any other takes the explicit unscale,
    vote and ``update(grads_finite=)``.
    Returns ``(params, state, scaler_state[, guard_state])``."""
    def vote(f):
        return sync_found_inf(f, sync_groups)

    if getattr(opt, "supports_update_scaled", False):
        new_params, new_state, finite = opt.update_scaled(
            grads, opt_state, params, scale=scaler_state.loss_scale, clip_norm=clip_grad_norm,
            finite_sync=vote, sumsq_reduce=clip_sumsq)
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
                          clip_grad_norm=None, sync_groups=(), clip_sumsq=None):
    """The JAX package's ``_apply_guarded_update``: no loss scale; the
    finite vote (agreed over ``sync_groups``) alone predicates the update
    and feeds the guard (an engine optimizer votes in its fused pass,
    ``scale=None``).  Returns ``(params, state, guard_state)``."""
    def vote(f):
        return sync_found_inf(f, sync_groups)

    if getattr(opt, "supports_update_scaled", False):
        new_params, new_state, finite = opt.update_scaled(
            grads, opt_state, params, clip_norm=clip_grad_norm, finite_sync=vote,
            sumsq_reduce=clip_sumsq)
    else:
        finite = vote(all_finite(grads))
        new_params, new_state = opt.update(grads, opt_state, params, grads_finite=finite)
    stepstats.offer("all_finite", finite)
    return new_params, new_state, step_guard.update(guard_state, finite)


def _dp_sync(opt, dp_group):
    """``(grad sync or None, loss mean or None)`` of a step: a ZeRO
    optimizer owns the grad sync (its reduce-scatter), so the step only
    averages the loss over its group; a replicated optimizer over a
    ``dp_group`` of more than one rank gets the DDP all-reduce
    (:func:`apex_tpu_torch.parallel.allreduce_gradients`) and the loss
    mean; otherwise neither.  The loss mean adds in rank order, the
    JAX step's ``pmean``."""
    from apex_tpu_torch.contrib.optimizers import _quantized_sync as qs
    from apex_tpu_torch.parallel.distributed import allreduce_gradients, process_group

    if hasattr(opt, "sharded_state_dict"):
        pg, world = opt._pg, opt.world_size
        grad_sync = None
    elif dp_group is not None and process_group(dp_group)[1] > 1:
        pg, world = process_group(dp_group)

        def grad_sync(grads):
            return allreduce_gradients(grads, group=dp_group)
    else:
        return None, None

    def loss_mean(loss):
        return qs.rank_order_sum(loss.reshape(1), pg, world)[0] / world

    return grad_sync, loss_mean


def make_train_step(opt, config, loss_scaler=None, step_guard=None, clip_grad_norm=None,
                    graphs=None, warmup=1, telemetry=None, dp_group=None,
                    overlap_grad_sync=False, tp_group=None, chaos=None):
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
    engine optimizer).  The new params, optimizer state and small states
    are copied into the given ones in place (the counterpart of donating
    them); the loss returned is the unscaled one.  Compiled unless
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
    when it has more than one rank.  Either way the loss returned is the
    mean over the group, as the JAX step's ``pmean``.  The collectives
    are captured with the rest of the step.  ``overlap_grad_sync=True``
    (the sync issued inside the backward) is not ported yet and
    raises.

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
    ZeRO optimizer with a tp group raises (``_zero_engine.TP_ITEM``).

    ``chaos``: a :class:`~apex_tpu_torch.resilience.chaos.ChaosMonkey`
    whose planned NaN steps poison the guarded step's gradients (it needs
    ``step_guard``, whose device step counter keys the plan): the loss is
    multiplied by :meth:`~apex_tpu_torch.resilience.chaos.ChaosMonkey
    .grad_fault` before the backward, on the device, so a captured step
    replays the plan with no host read; the guard then skips the step."""
    if overlap_grad_sync:
        from apex_tpu_torch.contrib.optimizers._zero_engine import OVERLAP_ITEM

        raise NotImplementedError(f"make_train_step(overlap_grad_sync=True) is not ported "
                                  f"yet: it comes with {OVERLAP_ITEM}")
    from apex_tpu_torch.models.gpt import _tp, check_tp, clip_sumsq_reduce

    tp = _tp(tp_group)
    if tp is not None:
        _refuse_zero_with_model_parallel(opt)
        check_tp(config, tp.size())
    clip_sumsq = (clip_sumsq_reduce(config, tp)
                  if tp is not None and clip_grad_norm is not None else None)

    def grads_fn(params, tokens, targets, post):
        return loss_and_grads(params, tokens, targets, config, post, axis_name=tp)

    return _make_step(opt, config, grads_fn, loss_scaler=loss_scaler, step_guard=step_guard,
                      clip_grad_norm=clip_grad_norm, graphs=graphs, warmup=warmup,
                      telemetry=telemetry, dp_group=dp_group, tp_group=tp,
                      sync_groups=() if tp is None else (tp,), clip_sumsq=clip_sumsq,
                      norm_sumsq=None if tp is None else clip_sumsq_reduce(config, tp),
                      chaos=chaos)


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


def _refuse_zero_with_model_parallel(opt):
    if hasattr(opt, "sharded_state_dict"):
        from apex_tpu_torch.contrib.optimizers._zero_engine import TP_ITEM

        raise NotImplementedError(f"a ZeRO optimizer with a tensor- or pipeline-parallel "
                                  f"group is not ported yet: it comes with {TP_ITEM}")


def _make_step(opt, config, grads_fn, *, loss_scaler=None, step_guard=None,
               clip_grad_norm=None, graphs=None, warmup=1, telemetry=None, dp_group=None,
               tp_group=None, sync_groups=(), clip_sumsq=None, norm_sumsq=None, chaos=None):
    """The step that :func:`make_train_step` and
    :func:`apex_tpu_torch.models.gpt.make_pp_train_step`): ``grads_fn(
    params, tokens, targets, post_loss) -> (loss, grads)`` gives the
    (scaled) loss and this rank's grads; then the sequence-parallel sum
    over ``tp_group``, the dp sync over ``dp_group``, the update (the
    finite vote agreed over ``sync_groups``, the clip's Σx² by
    ``clip_sumsq``), the telemetry window (its norms reduced by
    ``norm_sumsq`` when the params are slices) and the loss mean over
    dp; compiled unless ``graphs=False``.  ``chaos`` scales the loss by
    its planned fault before the scaler (the JAX steps' ``post_loss``).
    See :func:`make_train_step`."""
    from apex_tpu_torch.models.gpt import sp_grad_sync

    if chaos is not None and step_guard is None:
        raise ValueError("chaos NaN injection needs step_guard (the injection step counter "
                         "lives in GuardState)")
    grad_sync, loss_mean = _dp_sync(opt, dp_group)
    if clip_grad_norm is not None and not getattr(opt, "supports_update_scaled", False):
        raise ValueError("clip_grad_norm needs an engine optimizer (OptimizerBase "
                         "subclass): the clip folds into its fused grad pass")
    n_small = int(loss_scaler is not None) + int(step_guard is not None)
    n_state = n_small + int(telemetry is not None)

    def step(params, state, *rest):
        small, (tokens, targets) = rest[:n_small], rest[n_state:]
        if telemetry is None:
            loss, new = body(params, state, small, tokens, targets)
        else:
            with stepstats.capture(norm_sumsq) as cap:
                loss, new = body(params, state, small, tokens, targets)
            telemetry.accumulate_(
                rest[n_small], loss=loss, grad_norm=cap.get("grad_norm"),
                finite=cap.get("all_finite"),
                loss_scale=new[2].loss_scale if loss_scaler is not None else None,
                new_params=new[0], old_params=params, sumsq_reduce=norm_sumsq)
        with torch.no_grad():
            for dst, src in zip(tensor_leaves((params, state, *small)), tensor_leaves(new),
                                strict=True):
                dst.copy_(src)
        return loss

    def body(params, state, small, tokens, targets):
        """``(loss, (params, state, *small states))`` of one step."""
        scaler_state = small[0] if loss_scaler is not None else None
        guard_state = small[-1] if step_guard is not None else None
        fault = chaos.grad_fault(guard_state.step) if chaos is not None else None
        post = _post_loss(loss_scaler, scaler_state, fault)
        loss, grads = grads_fn(params, tokens, targets, post)
        if config.sequence_parallel:
            grads = sp_grad_sync(grads, tp_group)
        if grad_sync is not None:
            grads = grad_sync(grads)
        if loss_scaler is not None:
            loss = loss / scaler_state.loss_scale
            new = _apply_scaled_update(loss_scaler, scaler_state, grads, opt, state, params,
                                       step_guard=step_guard, guard_state=guard_state,
                                       clip_grad_norm=clip_grad_norm, sync_groups=sync_groups,
                                       clip_sumsq=clip_sumsq)
        elif step_guard is not None:
            new = _apply_guarded_update(grads, opt, state, params, step_guard, guard_state,
                                        clip_grad_norm=clip_grad_norm, sync_groups=sync_groups,
                                        clip_sumsq=clip_sumsq)
        elif clip_grad_norm is not None:
            new = opt.update(grads, state, params, clip_norm=clip_grad_norm,
                             sumsq_reduce=clip_sumsq)
        else:
            new = opt.update(grads, state, params)
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
