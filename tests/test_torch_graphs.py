"""The port's compiled steps (:mod:`apex_tpu_torch.graphs`) on the CPU,
at small widths.  The card captures CUDA graphs; the CPU has none, so
these tests hold what a capture relies on:

- no step body reads a device value on the host: each of the decode,
  verify, prefill, chunk and head steps, the dense and fused-CE train
  steps, the amp train steps (loss scaler, step guard, folded clip, in
  fp32 and fp16), and each optimizer's engine update (tree and resident
  state, clip, ``update_scaled``), runs under a dispatch mode that raises on
  ``aten._local_scalar_dense``, ``aten.item`` and ``aten.nonzero``
  (what ``int(t)``, ``bool(t)`` and data-dependent shapes dispatch to;
  a capture cannot hold them), with a control that must raise;
- the prefill and chunk given 0-d tensors for ``prompt_len``,
  ``start``, ``start_pos``, ``valid`` and ``write_start`` against the
  JAX package's ``make_prefill`` / ``make_prefill_chunk`` in fp32: pools
  and ``h_last`` within atol 1e-5 (the band of
  tests/test_torch_serving_v2.py: the frameworks sum in other orders),
  sampled tokens bitwise;
- the static-buffer path (a compiled step on the CPU) equal to a direct
  call of the plain step, bitwise, over several calls with changing
  inputs, for every serving step, both train steps and the amp train
  steps (the scaler and guard states too);
- the launch-count bookkeeping of a capture, driven by a stand-in;
- a compiled step given other pools, params or shapes raises;
- the CLIs' ``--eager`` runs equal their compiled runs.
"""

import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from apex_tpu.inference import (
    DecodeConfig as JaxDecodeConfig, KVCacheConfig as JaxKVCacheConfig,
    alloc_pools as jax_alloc_pools, make_prefill as jax_make_prefill,
    make_prefill_chunk as jax_make_prefill_chunk, make_sample_head as jax_make_sample_head,
)
from apex_tpu.models import gpt as jgpt

from apex_tpu_torch import graphs, ops, serve_gpt, train_gpt
from apex_tpu_torch.amp import DynamicLossScaler
from apex_tpu_torch.graphs import CapturedStep, add_counts, capture_counted, tensor_leaves
from apex_tpu_torch.inference import (
    DecodeConfig, KVCacheConfig, alloc_pools, make_decode_step,
    make_prefill, make_prefill_chunk, make_sample_head, make_verify_step,
)
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.resilience import StepGuard

TINY = dict(vocab_size=61, hidden_size=32, num_layers=2, num_attention_heads=4,
            max_seq_len=64, position_embedding_type="rope", checkpoint_layers=False)
CACHE = dict(num_pages=20, page_size=4, pages_per_seq=8)
B, W, S, C = 2, 3, 16, 4  # slots, verify width, prefill pad length, chunk

TRAIN_ARGV = ["--device", "cpu", "--layers", "2", "--hidden", "64", "--heads", "4",
              "--vocab", "128", "--seq", "32", "--batch", "2", "--compute-dtype", "float32"]
FUSED_ARGV = ["--fused-ce", "--fused-ce-chunk", "8"]

_HOST_READS = (torch.ops.aten._local_scalar_dense, torch.ops.aten.item,
               torch.ops.aten.nonzero)


class NoHostReads(TorchDispatchMode):
    """Raises on every op that reads a tensor's value on the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _HOST_READS:
            raise AssertionError(f"host read in a step body: {func}")
        return func(*args, **(kwargs or {}))


def _configs(**kw):
    base = {**TINY, **kw}
    return (jgpt.GPTConfig(**base, compute_dtype=jnp.float32),
            tgpt.GPTConfig(**base, compute_dtype=torch.float32))


@pytest.fixture(scope="module")
def model():
    """(jax config, jax params, port config, port params)."""
    jcfg, tcfg = _configs()
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _dcfg(temperature=1.0, **kw):
    return DecodeConfig(cache=KVCacheConfig(**CACHE, dtype=torch.float32), max_batch=B,
                        max_prompt_len=S, temperature=temperature, draft_len=W - 1,
                        prefill_chunk=C, **kw)


def _pools(tcfg):
    return alloc_pools(tcfg.num_layers, tcfg.kv_heads, tcfg.head_dim,
                       KVCacheConfig(**CACHE, dtype=torch.float32), device="cpu")


def _tables():
    return torch.arange(1, 1 + B * CACHE["pages_per_seq"], dtype=torch.int32).reshape(B, -1)


def _serving_inputs(rng, tcfg):
    """Random inputs for every serving step: {step: (builder, args after
    params and pools)}; the head takes no pools."""
    V = tcfg.vocab_size
    tables = _tables()

    def ints(*shape, hi=V):
        return torch.from_numpy(rng.randint(0, hi, size=shape).astype(np.int64))

    plen = int(rng.randint(1, S + 1))
    prompt = torch.zeros((1, S), dtype=torch.long)
    prompt[0, :plen] = ints(plen)
    start_pos = int(rng.randint(0, 8))
    return {
        "decode": (make_decode_step, (ints(B), ints(B, hi=20),
                                      torch.from_numpy(rng.rand(B) < 0.8), tables,
                                      ints(B, hi=2 ** 32))),
        "verify": (make_verify_step, (ints(B, W), ints(B, hi=20),
                                      torch.from_numpy(rng.rand(B) < 0.8), tables,
                                      ints(B, W, hi=2 ** 32))),
        "prefill": (make_prefill, (prompt, plen, int(rng.randint(0, plen)), tables[0],
                                   ints(1, hi=2 ** 32))),
        "chunk": (make_prefill_chunk, (ints(C), start_pos, int(rng.randint(1, C + 1)),
                                       start_pos + int(rng.randint(0, 2)), tables[1])),
        "head": (make_sample_head, (torch.from_numpy(rng.randn(tcfg.hidden_size)
                                                     .astype(np.float32)),
                                    ints(1, hi=2 ** 32))),
    }


def _call(step, name, params, pools, args):
    return step(params, *args) if name == "head" else step(params, pools, *args)


#: the amp train step's variants: make_train_step's keywords
AMP_VARIANTS = {
    "scaler": dict(loss_scaler=True),
    "scaler_guard_clip": dict(loss_scaler=True, step_guard=True, clip_grad_norm=0.5),
    "guard": dict(step_guard=True),
    "clip": dict(clip_grad_norm=0.5),
}


def _amp_step(variant, graphs_opt=None, fp16=False):
    """``(step, params, state, small states, tokens, targets)`` of an amp
    variant of the train step at TRAIN_ARGV's shape (fp16 compute with
    ``fp16``)."""
    config, params, state, opt, tokens, targets = _train_setup(False, fp16)
    kw = dict(AMP_VARIANTS[variant])
    small = []
    if kw.get("loss_scaler"):
        kw["loss_scaler"] = DynamicLossScaler(init_scale=2.0 ** 12, growth_interval=2)
        small.append(kw["loss_scaler"].init("cpu"))
    if kw.get("step_guard"):
        kw["step_guard"] = StepGuard(3)
        small.append(kw["step_guard"].init("cpu"))
    step = train_gpt.make_train_step(opt, config, graphs=graphs_opt, **kw)
    return step, params, state, small, tokens, targets


def _train_setup(fused, fp16=False):
    args = train_gpt.build_args().parse_args(TRAIN_ARGV + (FUSED_ARGV if fused else [])
                                             + (["--fp16"] if fp16 else []))
    config, params, tokens, targets = train_gpt.setup(args)
    opt = FusedAdam(lr=1e-3, weight_decay=0.1)
    for leaf in tensor_leaves(params):
        leaf.requires_grad_(True)
    return config, params, opt.init(params), opt, tokens, targets


# ------------------------------------------------------------ host reads
def test_no_host_reads_control_raises():
    t = torch.tensor(3)
    with NoHostReads(), pytest.raises(AssertionError, match="host read"):
        int(t)
    with NoHostReads(), pytest.raises(AssertionError, match="host read"):
        bool(t > 2)
    with NoHostReads(), pytest.raises(AssertionError, match="host read"):
        torch.tensor([True, False, True]).nonzero()


@pytest.mark.parametrize("name", ["decode", "verify", "prefill", "chunk", "head"])
def test_serving_step_bodies_read_nothing_on_the_host(model, name):
    """The compiled step (on the CPU: its static buffers, the ints as 0-d
    tensors) runs its body with no host read."""
    _, _, tcfg, tp = model
    builder, args = _serving_inputs(np.random.RandomState(0), tcfg)[name]
    step = builder(tcfg, _dcfg())
    assert isinstance(step, CapturedStep)
    with NoHostReads():
        _call(step, name, tp, _pools(tcfg), args)


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_body_reads_nothing_on_the_host(fused):
    """The loss, its gradients through remat and the flash (and CE)
    autograd Functions, the FusedAdam update and the in-place copies."""
    config, params, state, opt, tokens, targets = _train_setup(fused)
    step = train_gpt.make_train_step(opt, config)
    with NoHostReads():
        step(params, state, tokens, targets)


@pytest.mark.parametrize("fp16", [False, True], ids=["fp32", "fp16"])
@pytest.mark.parametrize("variant", sorted(AMP_VARIANTS))
def test_amp_train_step_body_reads_nothing_on_the_host(variant, fp16):
    """The scaled loss and its gradients, the fused unscale, vote and
    predicated update, the scaler's and the guard's branch-free updates
    and the in-place write-back of every state."""
    step, params, state, small, tokens, targets = _amp_step(variant, fp16=fp16)
    with NoHostReads():
        step(params, state, *small, tokens, targets)


@pytest.mark.parametrize("resident", [False, True], ids=["tree_state", "resident"])
@pytest.mark.parametrize("name", ["FusedAdam", "FusedSGD", "FusedLAMB", "FusedAdagrad",
                                  "FusedNovoGrad", "FusedMixedPrecisionLamb"])
def test_engine_update_reads_nothing_on_the_host(name, resident):
    """Each optimizer's engine path (the multi-tensor kernels' plain
    versions here), with tree or resident state: a plain update, a
    clip with a tensor lr, and ``update_scaled`` with a tensor scale,
    a clip and the finite vote, all without a host read."""
    from apex_tpu_torch import optimizers

    rng = np.random.RandomState(0)
    params = {"w": torch.from_numpy(rng.randn(9, 17).astype(np.float32)),
              "b": torch.from_numpy(rng.randn(33).astype(np.float32)),
              "s": torch.tensor(0.5)}
    grads = {k: torch.from_numpy(np.asarray(rng.randn(*v.shape), np.float32)) * 0.1
             for k, v in params.items()}
    kw = {"momentum": 0.9} if name == "FusedSGD" else {}
    opt = getattr(optimizers, name)(lr=1e-2, **kw)
    state = opt.init(params, bucketed=resident)
    with NoHostReads():
        p, s = opt.update(grads, state, params)
        p, s = opt.update(grads, s, p, clip_norm=1.0, lr=torch.tensor(1e-3))
        p, s, finite = opt.update_scaled(grads, s, p, scale=torch.tensor(1024.0),
                                         clip_norm=1.0)
    assert bool(finite) and int(s.step) == 3


# ------------------------------------------- tensor arguments against JAX
def test_prefill_and_chunk_with_tensor_arguments_match_jax(model):
    """One-shot prefill of 11 tokens written from position 3, then two
    chunks of another sequence (4 valid, then 3 valid with the write
    window starting at 5), then the sampling head, every scalar a 0-d
    tensor, against the JAX package's compiled steps (xla impls, fp32
    sampling dots) on the same params."""
    jcfg, jp, tcfg, tp = model
    jdcfg = JaxDecodeConfig(cache=JaxKVCacheConfig(**CACHE, dtype=jnp.float32), max_batch=B,
                            max_prompt_len=S, temperature=1.0, prefill_chunk=C,
                            attn_impl="xla", sample_impl="xla",
                            sample_dot_dtype=jnp.float32)
    dcfg = _dcfg()
    jpools = jax_alloc_pools(jcfg.num_layers, jcfg.kv_heads, jcfg.head_dim, jdcfg.cache)
    tpools = _pools(tcfg)
    tables = _tables()
    rng = np.random.RandomState(4)
    prompt = np.zeros((1, S), np.int32)
    prompt[0, :11] = rng.randint(0, 61, size=11)

    jpools, jfirst = jax_make_prefill(jcfg, jdcfg)(
        jp, jpools, jnp.asarray(prompt), jnp.int32(11), jnp.int32(3),
        jnp.asarray(tables[0].numpy()), jnp.uint32(12345))
    tpools, tfirst = make_prefill(tcfg, dcfg, graphs=False)(
        tp, tpools, torch.from_numpy(prompt).long(), torch.tensor(11), torch.tensor(3),
        tables[0], torch.tensor([12345]))
    assert int(tfirst[0]) == int(jfirst)

    jchunk = jax_make_prefill_chunk(jcfg, jdcfg)
    tchunk = make_prefill_chunk(tcfg, dcfg, graphs=False)
    for start_pos, valid, write_start in ((0, 4, 0), (4, 3, 5)):
        toks = np.zeros((C,), np.int32)
        toks[:valid] = rng.randint(0, 61, size=valid)
        jpools, jh = jchunk(jp, jpools, jnp.asarray(toks), jnp.int32(start_pos),
                            jnp.int32(valid), jnp.int32(write_start),
                            jnp.asarray(tables[1].numpy()))
        tpools, th = tchunk(tp, tpools, torch.from_numpy(toks).long(),
                            torch.tensor(start_pos), torch.tensor(valid),
                            torch.tensor(write_start), tables[1])
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    for name in ("k", "v"):  # page 0 is the garbage page: unordered duplicate writes
        np.testing.assert_allclose(tpools[name][:, 1:].numpy(),
                                   np.asarray(jpools[name])[:, 1:], rtol=0, atol=1e-5)
    jtok = jax_make_sample_head(jcfg, jdcfg)(jp, jh, jnp.uint32(999))
    ttok = make_sample_head(tcfg, dcfg, graphs=False)(tp, th, torch.tensor([999]))
    assert int(ttok[0]) == int(jtok)


# ------------------------------------------- static buffers = direct call
@pytest.mark.parametrize("name", ["decode", "verify", "prefill", "chunk", "head"])
def test_static_buffer_serving_step_equals_direct_call(model, name):
    """Four calls with new inputs each: outputs and pools bitwise equal
    to the plain step's on a second copy of the pools."""
    _, _, tcfg, tp = model
    dcfg = _dcfg()
    rng = np.random.RandomState(1)
    builder = _serving_inputs(rng, tcfg)[name][0]
    compiled, plain = builder(tcfg, dcfg), builder(tcfg, dcfg, graphs=False)
    pools_c, pools_p = _pools(tcfg), _pools(tcfg)
    for _ in range(4):
        args = _serving_inputs(rng, tcfg)[name][1]
        got = _call(compiled, name, tp, pools_c, args)
        want = _call(plain, name, tp, pools_p, args)
        for a, b in zip(tensor_leaves(got), tensor_leaves(want), strict=True):
            assert torch.equal(a, b)
        for key in ("k", "v"):
            assert torch.equal(pools_c[key], pools_p[key])
    assert compiled.calls == 4 and compiled.graph is None  # the CPU has no graphs


@pytest.mark.parametrize("fused", [False, True])
def test_static_buffer_train_step_equals_direct_call(fused):
    """Three steps on changing batches: losses, params and the whole
    optimizer state bitwise equal to the plain step's."""
    runs = []
    for graphs_opt in (None, False):
        config, params, state, opt, tokens, targets = _train_setup(fused)
        step = train_gpt.make_train_step(opt, config, graphs=graphs_opt)
        losses = []
        for i in range(3):
            losses.append(step(params, state, torch.roll(tokens, i, 1),
                               torch.roll(targets, i, 1)).clone())
        assert int(state.step) == 3
        runs.append((losses, tensor_leaves((params, state))))
    (lc, sc), (lp, sp) = runs
    assert all(torch.equal(a, b) for a, b in zip(lc, lp, strict=True))
    assert all(torch.equal(a, b) for a, b in zip(sc, sp, strict=True))


@pytest.mark.parametrize("variant", sorted(AMP_VARIANTS))
def test_static_buffer_amp_train_step_equals_direct_call(variant):
    """Three steps of each amp variant on changing batches: losses, params,
    the optimizer state and the scaler and guard states bitwise equal to
    the plain step's."""
    runs = []
    for graphs_opt in (None, False):
        step, params, state, small, tokens, targets = _amp_step(variant, graphs_opt)
        assert isinstance(step, CapturedStep) == (graphs_opt is None)
        losses = [step(params, state, *small, torch.roll(tokens, i, 1),
                       torch.roll(targets, i, 1)).clone() for i in range(3)]
        assert int(state.step) == 3
        runs.append((losses, tensor_leaves((params, state, *small))))
    (lc, sc), (lp, sp) = runs
    assert all(torch.equal(a, b) for a, b in zip(lc, lp, strict=True))
    assert all(torch.equal(a, b) for a, b in zip(sc, sp, strict=True))


# -------------------------------------------------------- launch counts
def _stand_in_capture(bumps, fail=False):
    """A stand-in for a capture: it bumps counters as the kernel
    wrappers do while a graph records them, and returns an output."""

    def capture():
        from apex_tpu_torch.ops import decode_attention, layer_norm

        layer_norm.LAUNCHES += bumps
        decode_attention.WIDE_LAUNCHES += 2 * bumps
        if fail:
            raise RuntimeError("capture failed")
        return "static outputs"

    return capture


def test_capture_leaves_counts_and_replays_add_the_delta():
    before = ops.launch_counts()
    assert len(before) == len(ops.COUNTERS)
    out, delta = capture_counted(_stand_in_capture(25))
    assert out == "static outputs"
    assert ops.launch_counts() == before
    assert delta == {"layer_norm.LAUNCHES": 25, "decode_attention.WIDE_LAUNCHES": 50}
    for _ in range(7):
        add_counts(delta)
    after = ops.launch_counts()
    assert after == {k: v + 7 * delta.get(k, 0) for k, v in before.items()}
    ops.restore_counts(before)


def test_failed_capture_restores_counts():
    before = ops.launch_counts()
    with pytest.raises(RuntimeError, match="capture failed"):
        capture_counted(_stand_in_capture(3, fail=True))
    assert ops.launch_counts() == before


def test_static_path_counts_as_eager():
    """On the CPU the kernels' plain versions count nothing, and the
    static path adds nothing of its own."""
    before = ops.launch_counts()
    step = CapturedStep(lambda x: x + 1)
    for i in range(3):
        assert int(step(torch.tensor([i]))[0]) == i + 1
    assert ops.launch_counts() == before


# ---------------------------------------------------------- refusals
def test_compiled_step_refuses_other_pools_params_and_shapes(model):
    _, _, tcfg, tp = model
    builder, args = _serving_inputs(np.random.RandomState(2), tcfg)["decode"]
    step = builder(tcfg, _dcfg())
    pools = _pools(tcfg)
    step(tp, pools, *args)
    with pytest.raises(ValueError, match="argument 1 is not the buffers"):
        step(tp, {k: v.clone() for k, v in pools.items()}, *args)
    with pytest.raises(ValueError, match="argument 0 is not the buffers"):
        step({k: v for k, v in tgpt.init_params(tcfg, 1, "cpu").items()}, pools, *args)
    with pytest.raises(ValueError, match="shape"):
        step(tp, pools, args[0][:1], *args[1:])
    step(tp, pools, *args)  # the step still runs on its own buffers


def test_compiled_train_step_refuses_other_params():
    config, params, state, opt, tokens, targets = _train_setup(False)
    step = train_gpt.make_train_step(opt, config)
    step(params, state, tokens, targets)
    other = {k: v for k, v in params.items()}
    other["embed"] = params["embed"].detach().clone().requires_grad_(True)
    with pytest.raises(ValueError, match="argument 0 is not the buffers"):
        step(other, state, tokens, targets)
    with pytest.raises(ValueError, match="argument 1 is not the buffers"):
        step(params, opt.init(params), tokens, targets)


def test_step_arguments_refused():
    with pytest.raises(TypeError, match="float"):
        CapturedStep(lambda x, y: x)(torch.zeros(1), 0.5)
    with pytest.raises(ValueError, match="a tensor argument"):
        CapturedStep(lambda n: n)(3)
    step = CapturedStep(lambda x: x + 1)
    step(torch.zeros(2))
    with pytest.raises(TypeError, match="captured with 1 arguments, got 2"):
        step(torch.zeros(2), torch.zeros(2))



def test_tensor_leaves_walk_in_tree_order():
    tree = {"b": [torch.zeros(1), None], "a": (1, torch.ones(1))}
    assert [float(t) for t in graphs.tensor_leaves(tree)] == [1.0, 0.0]


# ---------------------------------------------------------- the CLIs
@pytest.mark.parametrize("fused", [False, True])
def test_train_gpt_eager_equals_compiled(capsys, fused):
    argv = TRAIN_ARGV + ["--steps", "2"] + (FUSED_ARGV if fused else [])
    reports = []
    for extra in ([], ["--eager"]):
        assert train_gpt.main(argv + extra) == 0
        reports.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    compiled, eager = reports
    assert compiled["losses"] == eager["losses"] and len(eager["losses"]) == 3
    assert compiled["graphs"] is False and eager["graphs"] is False  # the CPU
    assert compiled["capture_ms"] == eager["capture_ms"] == 0.0


@pytest.mark.parametrize("v2", [False, True])
def test_serve_gpt_eager_equals_compiled(v2):
    argv = ["--device", "cpu", "--layers", "2", "--hidden", "64", "--heads", "4",
            "--vocab", "128", "--requests", "5", "--streams", "2", "--prompt-len", "8",
            "--max-new", "4", "--page-size", "4"]
    if v2:
        argv += ["--draft-len", "2", "--prefill-chunk", "4", "--prefix-sharing",
                 "--system-prompt-len", "8", "--best-effort-frac", "0.5"]
    tokens = []
    for extra in ([], ["--eager"]):
        out, sched, _, _ = serve_gpt.run(serve_gpt.build_args().parse_args(argv + extra))
        assert out["requests"] == 5 and out["graphs"] is False and out["capture_ms"] == 0.0
        tokens.append({c.rid: c.tokens for c in sched.completed})
    assert tokens[0] == tokens[1]
