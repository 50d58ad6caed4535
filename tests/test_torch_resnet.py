"""The port's ResNet (``apex_tpu_torch.models.resnet``), SyncBatchNorm,
LARC and ImageNet trainer against the JAX package on the CPU.

- ``variables_from_flax``: ResNet-50 has the flax model's params, name
  for name and shape for shape (25.6 M, ``test_resnet_example.py``'s
  count); an fp32 ResNet18ish at 32 x 32 and at 33 x 33 (whose
  ``"SAME"`` pads differ) matches flax within 1e-5 (logits, of their
  largest entry; the new ``batch_stats``) in training and eval, and its
  grads ``jax.grad``'s within 1e-4; a bf16 forward lies within 2^-4 of
  the largest logit (two stacks of bf16 convolutions that round in
  other orders);
- amp O2's cast, leaf by leaf, against the JAX ``amp.initialize``;
- one ``FusedSGD(master_weights=True)`` step, fp32 and under O2, against
  the JAX step;
- SyncBatchNorm: the four cases of ``tests/test_parallel.py``'s
  ``TestSyncBatchNorm`` (against ``torch.nn.BatchNorm2d``,
  ``channel_last``, eval on the running stats, sharded against the full
  batch) and, on one gloo world of 2, sharded even (4 + 4) and uneven
  (3 + 5) against the JAX full-batch result with grads, the ResNet18ish
  dp 2 step (SyncBN over the world, ``allreduce_gradients``) against the
  JAX full-batch loss, grads and running stats, and
  ``create_syncbn_process_group``; the refusals against the JAX ones;
- LARC: ``tests/test_parallel.py``'s two cases, a zero-norm leaf and
  scale mode, on the bucketed and the per-leaf path, against the JAX
  LARC's params;
- the trainer: ``--device cpu --small --steps 2 --batch-size 4
  --image-size 32 --checkpoint``, then ``--resume`` prints ``step 2`` and
  its losses equal the uninterrupted run's; ``--dp 2`` under a
  ``torchrun`` world (``parallel.multiproc.launch``) on gloo.
"""

import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.tree_util import keystr, tree_flatten_with_path

from apex_tpu import amp as jamp
from apex_tpu.models.resnet import ResNet18ish as JaxResNet18ish
from apex_tpu.models.resnet import ResNet50 as JaxResNet50
from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.parallel import LARC as JaxLARC
from apex_tpu.parallel import SyncBatchNorm as JaxSyncBatchNorm
from apex_tpu.parallel import convert_syncbn_model as jax_convert_syncbn_model
from apex_tpu.parallel import create_syncbn_process_group as jax_create_syncbn_process_group

from apex_tpu_torch import amp as tamp
from apex_tpu_torch.imagenet_main_amp import loss_and_grads
from apex_tpu_torch.models import resnet as tresnet
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.optimizers.tree import tree_leaves
from apex_tpu_torch.parallel import (
    LARC,
    SyncBatchNorm,
    convert_syncbn_model,
    create_syncbn_process_group,
    multiproc,
)

REPO = Path(__file__).resolve().parent.parent
#: fp32 forward (of the largest logit; batch stats absolute) and grads
#: (of each leaf's largest entry)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
#: bf16 forward, of the largest logit
BF16_TOL = 2.0 ** -4
CLASSES = 10
BATCH = 4
#: SyncBN sharded against full batch (out, grads), tests/test_parallel.py's
SYNC_TOL = 1e-4
#: the two ranks' rows of the 8-row SyncBN batch
SPLITS = {"even": (4, 4), "uneven": (3, 5)}
SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: a CPU shared by parallel test workers slows
    many-thread convolutions by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(size, seed=0, n=BATCH):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, size, size, 3), dtype=np.float32),
            rng.integers(0, CLASSES, size=(n,)))


@functools.lru_cache(maxsize=None)
def _flax_vars(size, dtype=jnp.float32):
    m = JaxResNet18ish(num_classes=CLASSES, dtype=dtype)
    v = m.init(jax.random.PRNGKey(0), jnp.zeros((2, size, size, 3)), train=True)
    # non-trivial batch-norm affines, so their grads and the normalized
    # values are exercised
    rng = np.random.default_rng(1)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) + (rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
                                      if "SyncBatchNorm" in keystr(p) and "params" in keystr(p)
                                      else 0), v)
    return m, v


@functools.lru_cache(maxsize=None)
def _jax_loss(size, dtype=jnp.float32):
    """The jitted JAX ``value_and_grad`` of the trainer's loss, with the
    logits and new ``batch_stats`` beside it."""
    m = _flax_vars(size, dtype)[0]

    def loss_fn(params, bs, x, y):
        logits, upd = m.apply({"params": params, "batch_stats": bs}, x, train=True,
                              mutable=["batch_stats"])
        onehot = jax.nn.one_hot(y, CLASSES)
        return -jnp.mean(jnp.sum(onehot * jax.nn.log_softmax(logits), -1)), (
            logits, upd["batch_stats"])

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _port(size_vars, dtype=torch.float32, group=None):
    model = tresnet.ResNet18ish(num_classes=CLASSES, dtype=dtype, device="cpu",
                                sync_bn_group=group)
    tv = tresnet.variables_from_flax(size_vars, "cpu")
    return model, tv["params"], tv["batch_stats"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-6)


def _flat_named(tree):
    """``{port name: numpy}`` of a flax ``params`` / ``batch_stats`` tree,
    in the port's layout."""
    out = {}
    for path, a in tree_flatten_with_path(tree)[0]:
        name = tresnet.flax_name([p.key for p in path])
        out[name] = tresnet._from_flax_leaf(name, np.asarray(a, np.float32)).numpy()
    return out


def test_same_pads_are_flax_pads():
    assert tresnet.same_pads(224, 7, 2) == (2, 3)
    assert tresnet.same_pads(56, 3, 2) == (0, 1)
    assert tresnet.same_pads(112, 3, 2) == (0, 1)
    assert tresnet.same_pads(56, 1, 2) == (0, 0)
    assert tresnet.same_pads(33, 3, 1) == (1, 1)
    assert tresnet.same_pads(33, 7, 2) == (3, 3)


def test_resnet50_matches_flax_tree():
    m = JaxResNet50()
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                           train=True))
    port = tresnet.ResNet50(device="cpu").variables()
    for col in ("params", "batch_stats"):
        want = {}
        for path, s in tree_flatten_with_path(shapes[col])[0]:
            name = tresnet.flax_name([p.key for p in path])
            shape = s.shape
            want[name] = ((shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4
                          else shape[::-1] if name == "fc_weight" else shape)
        assert {k: tuple(v.shape) for k, v in port[col].items()} == want
    n = sum(int(np.prod(p.shape)) for p in port["params"].values())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert 20_000_000 < n < 30_000_000
    small = tresnet.ResNet18ish(device="cpu")
    v = small.variables()
    logits, _ = small.apply(v["params"], v["batch_stats"], torch.zeros(1, 32, 32, 3))
    assert logits.shape == (1, 1000) and logits.dtype == torch.float32


@pytest.mark.parametrize("size", [32, 33])
def test_fp32_forward_and_grads_match_flax(size):
    m, v = _flax_vars(size)
    x, y = _images(size)
    (jloss, (jlogits, jbs)), jg = _jax_loss(size)(v["params"], v["batch_stats"], x, y)
    model, params, stats = _port(v)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    logits, new = model.apply(params, stats, torch.from_numpy(x), train=True)
    assert _rel(logits.detach(), jlogits) < FWD_TOL
    want_bs = _flat_named(jbs)
    for k, a in new.items():
        np.testing.assert_allclose(a.numpy(), want_bs[k], rtol=FWD_TOL, atol=FWD_TOL)
        assert not torch.equal(a, stats[k])  # the inputs are left as they were
    loss, grads = loss_and_grads(model, params, {k: t.clone() for k, t in stats.items()},
                                 torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(loss) - float(jloss)) <= FWD_TOL * abs(float(jloss))
    want_g = _flat_named(jg)
    assert set(grads) == set(want_g)
    for k, g in grads.items():
        assert _rel(g, want_g[k]) < GRAD_TOL, k
    # eval: the running statistics normalize
    jeval = m.apply({"params": v["params"], "batch_stats": jbs}, x, train=False)
    ev, same = model.apply(params, new, torch.from_numpy(x), train=False)
    assert same is new
    assert _rel(ev.detach(), jeval) < FWD_TOL


def test_bf16_forward_within_band():
    m, v = _flax_vars(32, jnp.bfloat16)
    x, _ = _images(32)
    jlogits, _ = jax.jit(lambda v, x: m.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
    model, params, stats = _port(v, torch.bfloat16)
    logits, _ = model.apply(params, stats, torch.from_numpy(x), train=True)
    assert logits.dtype == torch.float32
    assert _rel(logits.detach(), jlogits) < BF16_TOL


def test_amp_o2_cast_matches_jax_leaf_by_leaf():
    _, v = _flax_vars(32)
    jparams, _ = jamp.initialize(v["params"], opt_level="O2")
    want = {tresnet.flax_name([p.key for p in path]): str(a.dtype)
            for path, a in tree_flatten_with_path(jparams)[0]}
    _, params, _ = _port(v)
    got, _ = tamp.initialize(params, opt_level="O2")
    assert {k: str(t.dtype).replace("torch.", "") for k, t in got.items()} == want
    assert {d for d in want.values()} == {"float32", "bfloat16"}


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_fused_sgd_master_step_matches_jax(opt_level):
    _, v = _flax_vars(32)
    x, y = _images(32)
    jparams, _ = jamp.initialize(v["params"], opt_level=opt_level)
    jopt = JaxFusedSGD(**SGD, master_weights=True)
    (_, (_, _)), jg = _jax_loss(32)(jparams, v["batch_stats"], x, y)
    jnew, jstate = jax.jit(jopt.update)(jg, jopt.init(jparams), jparams)
    model, params, stats = _port(v)
    params, _ = tamp.initialize(params, opt_level=opt_level)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = FusedSGD(**SGD, master_weights=True)
    state = opt.init(params)
    _, grads = loss_and_grads(model, params, stats, torch.from_numpy(x), torch.from_numpy(y))
    opt.update(grads, state, params, inplace=True)
    want, want_master, want_g = _flat_named(jnew), _flat_named(jstate.master), _flat_named(jg)
    dtypes = {tresnet.flax_name([q.key for q in path]): str(a.dtype)
              for path, a in tree_flatten_with_path(jnew)[0]}
    for k, p in params.items():
        assert str(p.dtype).replace("torch.", "") == dtypes[k]
        # the master moves by lr x grad: within the grads' band, and under
        # O2 within one bf16 ulp of the leaf's largest grad (a bf16 grad
        # summed in another order can round the other way)
        step_tol = SGD["lr"] * np.abs(want_g[k]).max() * (
            2.0 ** -7 if p.dtype == torch.bfloat16 else GRAD_TOL)
        np.testing.assert_allclose(state.master[k].numpy(), want_master[k], rtol=1e-5,
                                   atol=step_tol)
        np.testing.assert_allclose(p.detach().float().numpy(), want[k],
                                   rtol=2.0 ** -8 if p.dtype == torch.bfloat16 else 1e-5,
                                   atol=step_tol)


# ------------------------------------------------------------- SyncBN
def _torch_bn(x, momentum=0.1, eps=1e-5):
    bn = torch.nn.BatchNorm2d(x.shape[1], momentum=momentum, eps=eps)
    bn.train()
    out = bn(torch.tensor(x))
    return out.detach().numpy(), bn.running_mean.numpy(), bn.running_var.numpy()


class TestSyncBatchNorm:
    def test_matches_torch_single_device(self):
        x = np.random.RandomState(0).randn(4, 3, 5, 5).astype(np.float32)
        m = SyncBatchNorm(3, group=None, device="cpu")
        out = m(torch.from_numpy(x))
        ref_out, ref_mean, ref_var = _torch_bn(x)
        np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(m.running_mean.numpy(), ref_mean, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(m.running_var.numpy(), ref_var, rtol=1e-4, atol=1e-5)

    def test_channel_last_matches_jax(self):
        x = np.random.RandomState(2).randn(2, 5, 5, 3).astype(np.float32)
        jm = JaxSyncBatchNorm(num_features=3, axis_name=None, channel_last=True)
        jv = jm.init(jax.random.PRNGKey(0), x)
        jout, jupd = jm.apply(jv, x, mutable=["batch_stats"])
        m = SyncBatchNorm(3, group=None, channel_last=True, device="cpu")
        out = m(torch.from_numpy(x))
        assert out.shape == x.shape
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out.detach().numpy().reshape(-1, 3).mean(0), np.zeros(3),
                                   atol=1e-4)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(getattr(m, k).numpy(),
                                       np.asarray(jupd["batch_stats"][k]), rtol=1e-6)

    def test_eval_uses_running_stats(self):
        x = torch.ones(2, 3, 4, 4)
        m = SyncBatchNorm(3, group=None, device="cpu")
        out = m(x, use_running_average=True)
        np.testing.assert_allclose(out.detach().numpy(), x.numpy(), rtol=1e-5)
        assert torch.equal(m.running_mean, torch.zeros(3))

    def test_bf16_in_bf16_out(self):
        x = torch.randn(4, 3, 4, 4).bfloat16()
        out = SyncBatchNorm(3, group=None, device="cpu")(x)
        assert out.dtype == torch.bfloat16

    def test_default_group_is_the_data_parallel_group(self):
        from apex_tpu_torch.transformer import parallel_state as ps

        if ps.model_parallel_is_initialized():
            pytest.skip("a model-parallel state is registered in this process")
        with pytest.raises(RuntimeError, match="model parallel is not initialized"):
            SyncBatchNorm(3, device="cpu")(torch.randn(2, 3, 2, 2))
        with pytest.raises(ValueError, match="AxisGroup"):
            SyncBatchNorm(3, group="tp", device="cpu")(torch.randn(2, 3, 2, 2))


def test_refusals_match_jax():
    for size, world in ((3, 2), (0, 4), (3, 8)):
        with pytest.raises(ValueError) as want:
            jax_create_syncbn_process_group(size, world)
        with pytest.raises(ValueError) as got:
            create_syncbn_process_group(size, world)
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError):
        jax_convert_syncbn_model(None)
    with pytest.raises(NotImplementedError, match="sync_bn_group"):
        convert_syncbn_model(torch.nn.BatchNorm2d(3))
    g = create_syncbn_process_group(1)  # no process group: a one-rank world
    assert (g.size(), g.rank(), g.ranks) == (1, 0, (0,))


CHILD = r'''
import sys, pickle
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from apex_tpu_torch.parallel import (
    SyncBatchNorm, allreduce_gradients, create_syncbn_process_group, destroy_distributed,
    initialize_distributed)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.models import resnet
from apex_tpu_torch.imagenet_main_amp import loss_and_grads
x_bn, w_bn, SPLITS, flax_vars, x_rn, y_rn = pickle.load(open(sys.argv[3], "rb"))
initialize_distributed("cpu")
ps.initialize_model_parallel()
rank = dist.get_rank()
dp = ps.get_data_parallel_group()
out = {"groups": {}}
for size in (1, 2):
    g = create_syncbn_process_group(size)
    out["groups"][size] = (g.size(), g.rank(), g.ranks, str(g))
for name, (a, b) in SPLITS.items():
    rows = slice(0, a) if rank == 0 else slice(a, a + b)
    m = SyncBatchNorm(3, group=dp, device="cpu")
    with torch.no_grad():
        m.weight.copy_(torch.tensor([1.5, 0.5, -1.0]))
        m.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    x = torch.from_numpy(x_bn[rows]).requires_grad_(True)
    y = m(x)
    loss = (torch.sin(y) * torch.from_numpy(w_bn[rows])).sum()
    gx, gw, gb = torch.autograd.grad(loss, (x, m.weight, m.bias))
    # the params' grads are this rank's share: their sum is the full batch's
    for t in (gw, gb):
        dist.all_reduce(t)
    out[name] = (y.detach(), gx, gw, gb, m.running_mean.clone(), m.running_var.clone())
# the ResNet18ish dp 2 step: SyncBN over the world, grads all-reduced
model = resnet.ResNet18ish(num_classes=10, dtype=torch.float32, device="cpu",
                           sync_bn_group=dp)
tv = resnet.variables_from_flax(flax_vars, "cpu")
params, stats = tv["params"], tv["batch_stats"]
for leaf in params.values():
    leaf.requires_grad_(True)
half = len(x_rn) // 2
rows = slice(rank * half, (rank + 1) * half)
loss, grads = loss_and_grads(model, params, stats, torch.from_numpy(x_rn[rows]),
                             torch.from_numpy(y_rn[rows]))
grads = allreduce_gradients(grads, dp)
dist.all_reduce(loss)
out["resnet"] = (float(loss) / 2, grads, stats)
# the control: the same step with SyncBN's cotangents left unsummed
from apex_tpu_torch.parallel import sync_batchnorm
sync_batchnorm._SumOverGroup.backward = staticmethod(lambda ctx, g: (g.clone(), None))
tv = resnet.variables_from_flax(flax_vars, "cpu")
for leaf in tv["params"].values():
    leaf.requires_grad_(True)
_, grads = loss_and_grads(model, tv["params"], tv["batch_stats"],
                          torch.from_numpy(x_rn[rows]), torch.from_numpy(y_rn[rows]))
out["resnet_control"] = allreduce_gradients(grads, dp)
torch.save(out, sys.argv[2] + f"/rank{rank}.pt")
destroy_distributed()
'''


def _bn_inputs():
    rng = np.random.RandomState(1)
    return rng.randn(8, 3, 4, 4).astype(np.float32), rng.randn(8, 3, 4, 4).astype(np.float32)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    d = tmp_path_factory.mktemp("syncbn")
    x_bn, w_bn = _bn_inputs()
    _, v = _flax_vars(32)
    x_rn, y_rn = _images(32)
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((x_bn, w_bn, SPLITS, v, x_rn, y_rn), f)
    multiproc.launch(["-c", CHILD, str(REPO), str(d), str(d / "in.pkl")], 2, timeout=300)
    return [torch.load(d / f"rank{r}.pt") for r in range(2)]


def _jax_bn_full():
    """The JAX full-batch SyncBatchNorm: out, the grads of Σ sin(out)·w
    and the new running statistics."""
    x, w = _bn_inputs()
    m = JaxSyncBatchNorm(num_features=3, axis_name=None)
    v = m.init(jax.random.PRNGKey(0), x)
    params = {"weight": jnp.array([1.5, 0.5, -1.0]), "bias": jnp.array([0.1, -0.2, 0.3])}

    def f(x, params):
        y, upd = m.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                         mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y) * w), (y, upd["batch_stats"])

    (_, (y, bs)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(x, params)
    return (np.asarray(y), np.asarray(gx), np.asarray(gp["weight"]), np.asarray(gp["bias"]),
            np.asarray(bs["running_mean"]), np.asarray(bs["running_var"]))


@pytest.mark.parametrize("split", list(SPLITS))
def test_syncbn_sharded_matches_jax_full_batch(world2, split):
    y, gx, gw, gb, rm, rv = _jax_bn_full()
    a, _ = SPLITS[split]
    got = [torch.cat([world2[0][split][i], world2[1][split][i]]).numpy() for i in (0, 1)]
    np.testing.assert_allclose(got[0], y, rtol=SYNC_TOL, atol=SYNC_TOL)
    np.testing.assert_allclose(got[1], gx, rtol=SYNC_TOL, atol=SYNC_TOL)
    assert world2[0][split][0].shape[0] == a
    for rank in world2:
        for t, want in zip(rank[split][2:], (gw, gb, rm, rv)):
            np.testing.assert_allclose(t.numpy(), want, rtol=SYNC_TOL, atol=SYNC_TOL)


def test_resnet_dp2_step_matches_jax_full_batch(world2):
    _, v = _flax_vars(32)
    x, y = _images(32)
    (jloss, (_, jbs)), jg = _jax_loss(32)(v["params"], v["batch_stats"], x, y)
    want_g, want_bs = _flat_named(jg), _flat_named(jbs)
    for rank in world2:
        loss, grads, stats = rank["resnet"]
        assert abs(loss - float(jloss)) <= FWD_TOL * abs(float(jloss))
        for k, g in grads.items():
            assert _rel(g, want_g[k]) < GRAD_TOL, k
        for k, s in stats.items():
            np.testing.assert_allclose(s.numpy(), want_bs[k], rtol=FWD_TOL, atol=FWD_TOL)


def test_resnet_dp2_control_misses_with_unsummed_cotangents(world2):
    """The dp 2 step with SyncBN's backward keeping each rank's own
    cotangents (no all-reduce) lies far outside the band the real step
    meets: the band sees a backward that skips the sum."""
    _, v = _flax_vars(32)
    x, y = _images(32)
    _, jg = _jax_loss(32)(v["params"], v["batch_stats"], x, y)
    want_g = _flat_named(jg)
    for rank in world2:
        worst = max(_rel(g, want_g[k]) for k, g in rank["resnet_control"].items())
        assert worst > 100 * GRAD_TOL, worst


def test_create_syncbn_process_group_in_a_world(world2):
    for r, rank in enumerate(world2):
        assert rank["groups"][1] == (1, 0, (r,), "dp_sync")
        assert rank["groups"][2] == (2, r, (0, 1), "dp_sync")


# ---------------------------------------------------------------- LARC
LARC_CASES = {
    # tests/test_parallel.py's clip case: one leaf
    "clip": (True, 0.01, False),
    # a leaf of zero norm is left as it was; scale mode
    "zero_leaf": (True, 0.01, True),
    "scale": (False, 0.01, True),
}


@pytest.mark.parametrize("use_buckets", [True, False], ids=["engine", "per_leaf"])
@pytest.mark.parametrize("case", list(LARC_CASES))
def test_larc_matches_jax(case, use_buckets):
    clip, wd, more = LARC_CASES[case]
    rng = np.random.RandomState(3)
    p = {"w": rng.randn(10).astype(np.float32)}
    g = {"w": (rng.randn(10) * 0.01).astype(np.float32)}
    if more:
        p.update(z=np.zeros(5, np.float32), m=rng.randn(3, 4).astype(np.float32))
        g.update(z=rng.randn(5).astype(np.float32), m=rng.randn(3, 4).astype(np.float32))
    jopt = JaxLARC(JaxFusedSGD(lr=0.1, weight_decay=wd), trust_coefficient=0.02, clip=clip)
    jp = jax.tree.map(jnp.asarray, p)
    want, _ = jopt.update(jax.tree.map(jnp.asarray, g), jopt.init(jp), jp)
    inner = FusedSGD(lr=0.1, weight_decay=wd, use_buckets=use_buckets)
    opt = LARC(inner, trust_coefficient=0.02, clip=clip)
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    got, _ = opt.update({k: torch.from_numpy(a) for k, a in g.items()}, opt.init(tp), tp)
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)
    assert inner.weight_decay == wd
    if case == "clip":  # the reference math (apex/parallel/LARC.py:78-104) + an SGD step
        pn, gn = np.linalg.norm(p["w"]), np.linalg.norm(g["w"])
        adaptive = min(0.02 * pn / (gn + pn * wd + 1e-8) / 0.1, 1.0)
        np.testing.assert_allclose(got["w"].numpy(),
                                   p["w"] - 0.1 * (g["w"] + wd * p["w"]) * adaptive,
                                   rtol=1e-5, atol=1e-6)


def test_larc_restores_wd():
    inner = FusedSGD(lr=0.1, weight_decay=0.5)
    opt = LARC(inner)
    params = {"w": torch.ones(4)}
    opt.update({"w": torch.ones(4)}, opt.init(params), params)
    assert inner.weight_decay == 0.5


# ------------------------------------------------------------- trainer
TRAIN = ["--device", "cpu", "--small", "--batch-size", "4", "--image-size", "32"]


def _losses(stdout):
    return {int(ln.split()[1][:-1]): ln.split()[-1] for ln in stdout.splitlines()
            if ln.startswith("step ")}


def _trainer(*argv):
    r = subprocess.run([sys.executable, "-m", "apex_tpu_torch.imagenet_main_amp", *TRAIN,
                        *argv], cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def full_run():
    """The losses of an uninterrupted 4-step run."""
    return _losses(_trainer("--steps", "4"))


def test_trainer_checkpoint_and_resume(tmp_path, full_run):
    ck = tmp_path / "ck.pt"
    full = full_run
    first = _trainer("--steps", "2", "--checkpoint", str(ck))
    assert ck.exists() and "checkpoint saved to" in first
    resumed = _trainer("--steps", "2", "--resume", str(ck))
    assert "step 2" in resumed and "step 0" not in resumed
    assert "throughput:" in resumed
    assert {**_losses(first), **_losses(resumed)} == full


def test_trainer_dp2_under_torchrun(full_run):
    out = multiproc.launch(["-m", "apex_tpu_torch.imagenet_main_amp", *TRAIN, "--dp", "2",
                            "--steps", "2"], 2, cwd=REPO, timeout=300)
    assert "dp=2" in out[0].stdout and out[1].stdout == ""
    losses = _losses(out[0].stdout)
    assert sorted(losses) == [0, 1]
    # SyncBN and the mean grad over two ranks of 2 rows train what one
    # rank does on 4, up to the bf16 convolutions' rounding
    for s in (0, 1):
        assert abs(float(losses[s]) - float(full_run[s])) < 2e-2


def test_trainer_dp_must_be_the_world():
    from apex_tpu_torch import imagenet_main_amp

    args = imagenet_main_amp.build_args().parse_args([*TRAIN, "--dp", "2", "--steps", "1"])
    with pytest.raises(ValueError, match="--dp 2, but the world has 1 ranks"):
        imagenet_main_amp.run(args)
