"""The port's fault injection (``apex_tpu_torch.resilience.chaos``)
against the JAX package's, on the CPU.

- plan parsing: ``ChaosPlan.make`` normalizes its arguments as the JAX
  package's does, and ``SupervisorFaultScript.from_dict`` gives the same
  per-attempt faults (and refuses an unknown key with the same message);
- every host-side decision (``maybe_preempt``, ``maybe_wedge``,
  ``maybe_wedge_step``, ``maybe_kill``, ``maybe_kill_replica``,
  ``maybe_wedge_replica``, ``io_fault``) fires on the same steps, ranks,
  replicas and attempts, and counts the same ``injected`` faults;
- ``grad_fault`` is NaN on exactly the planned steps, a 0-d fp32 device
  tensor compared with the guard's device step counter, and inside the
  guarded train step (``make_train_step(step_guard=, chaos=)``, the
  compiled path: a ``CapturedStep`` over static buffers on the CPU) it
  skips exactly the planned step: the losses (NaN on the same step,
  finite ones within 1e-5 relative, fp32), the guard state, the Adam
  counter and (with a scaler) every loss scale equal to JAX
  ``make_train_step``'s; the pipelined step (``make_pp_train_step``
  over a one-rank gloo group) skips the planned step with its params
  bitwise unchanged and the guard state JAX's ``StepGuard`` gives for
  that vote;
- ``check_io`` at the checkpoint seam: injected write failures are
  retried through (the file is the one a clean save writes), a read
  that stays down raises ``ChaosIOError``, each with the JAX package's
  ``injected`` counts;
- ``corrupt_newest_checkpoint`` flips the same bytes as the JAX
  package's, and ``probe_checkpoint_dir`` names the file;
- ``ElasticRunController.on_step`` delivers the planned kill (exit 137);
- a plan that arms a kernel-launch failure, or the in-step collective
  wedge, raises at construction and names why (the port has no
  fallback and a captured graph runs no host callback), where the JAX
  package accepts it.
"""

import dataclasses
import json
import math
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from apex_tpu.amp import DynamicLossScaler as JaxScaler
from apex_tpu.io import checkpoint as jckpt
from apex_tpu.models import gpt as jgpt
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu.resilience import StepGuard as JaxStepGuard
from apex_tpu.resilience import chaos as J

from apex_tpu_torch import train_gpt
from apex_tpu_torch.amp import DynamicLossScaler
from apex_tpu_torch.graphs import CapturedStep
from apex_tpu_torch.io import checkpoint as tckpt
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.tree import tree_leaves
from apex_tpu_torch.resilience import StepGuard
from apex_tpu_torch.resilience import chaos as C
from apex_tpu_torch.resilience import elastic

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_attention_heads=4,
            max_seq_len=16, checkpoint_layers=True, use_flash_attention=True)
BAND = 1e-5
STEPS = 4

PLAN = dict(nan_grad_steps=[3, 1], preempt_at_step=2, wedge_seconds={"bench.x": 0.01},
            kill_at={"1": 4, 0: "2"}, wedge_step_at=3, wedge_step_seconds=0.01,
            io_failures={"ckpt.write": 2}, io_delay_seconds={"ckpt.read": 0.0},
            kill_replica_at={0: 5}, wedge_replica_at={"r1": "2"})


def _plain(plan):
    return {f.name: (sorted(v) if isinstance(v, frozenset) else
                     dict(v) if isinstance(v, dict) else v)
            for f, v in ((f, getattr(plan, f.name)) for f in dataclasses.fields(plan))}


def test_plan_parsing_matches_jax():
    assert _plain(C.ChaosPlan.make(**PLAN)) == _plain(J.ChaosPlan.make(**PLAN))
    assert _plain(C.ChaosPlan.make()) == _plain(J.ChaosPlan.make())
    spec = {"0": {"args": ["--chaos-kill-at-step", 3]},
            "1": {"args": ["--watchdog-secs", "3"], "corrupt_newest_checkpoint": True},
            "4": {}}
    got, want = C.SupervisorFaultScript.from_dict(spec), J.SupervisorFaultScript.from_dict(spec)
    assert {k: dataclasses.asdict(v) for k, v in got.faults.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.faults.items()}
    assert got.fault_for(2) is None and got.fault_for(1).corrupt_newest_checkpoint
    for mod in (C, J):
        with pytest.raises(ValueError, match=r"unknown key\(s\) \['argz'\]"):
            mod.SupervisorFaultScript.from_dict({"0": {"argz": []}})


class _Handler:
    def __init__(self):
        self.reasons = []

    def simulate(self, reason="simulated (chaos)"):
        self.reasons.append(reason)


def _decisions(mod):
    m = mod.ChaosMonkey(mod.ChaosPlan.make(**PLAN))
    out = []
    h = _Handler()
    for step in range(6):
        row = [m.maybe_preempt(step, h), m.maybe_wedge_step(step) > 0,
               m.maybe_wedge_replica("r1", step), m.maybe_wedge_replica("r0", step)]
        for rank in (0, 1):
            try:
                m.maybe_kill(step, rank=rank)
                row.append(None)
            except SystemExit as e:
                row.append((type(e).__name__, e.code, e.rank, e.step))
        try:
            m.maybe_kill_replica("0", step)
            row.append(None)
        except SystemExit as e:
            row.append((type(e).__name__, e.code, e.replica_id, e.step))
        out.append(row)
    m.maybe_wedge("bench.x")
    m.maybe_wedge("bench.y")
    io = []
    for _ in range(3):
        try:
            m.io_fault("ckpt.write")
            io.append("ok")
        except OSError as e:
            io.append(type(e).__name__)
    return out, io, h.reasons, dict(m.injected)


def test_host_decisions_match_jax():
    got, want = _decisions(C), _decisions(J)
    assert got == want
    rows = got[0]
    assert rows[2][0] is True and rows[4][5] == ("ChaosHostKilled", 137, 1, 4)
    assert got[1] == ["ChaosIOError", "ChaosIOError", "ok"]


def test_grad_fault_is_nan_on_the_planned_steps_only():
    m, jm = C.ChaosMonkey(C.ChaosPlan.make(nan_grad_steps=[1, 3])), \
        J.ChaosMonkey(J.ChaosPlan.make(nan_grad_steps=[1, 3]))
    for s in range(5):
        f = m.grad_fault(torch.tensor(s, dtype=torch.int32))
        assert f.dtype == torch.float32 and f.dim() == 0
        assert math.isnan(float(f)) == math.isnan(float(jm.grad_fault(jnp.int32(s))))
        assert math.isnan(float(f)) == (s in (1, 3))
    one = C.ChaosMonkey(C.ChaosPlan.make()).grad_fault(torch.tensor(1, dtype=torch.int32))
    assert float(one) == 1.0


def _batch(batch=4, seed=0):
    tok = np.random.RandomState(seed).randint(0, TINY["vocab_size"], size=(batch, 16))
    return tok, np.roll(tok, -1, axis=1)


def _jax_run(scaled):
    config = jgpt.GPTConfig(**TINY, compute_dtype=jnp.float32)
    params = jgpt.init_params(config, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    opt, guard = JaxFusedAdam(lr=1e-2), JaxStepGuard(3)
    scaler = JaxScaler(init_scale=2.0 ** 8, hysteresis=1) if scaled else None
    chaos = J.ChaosMonkey(J.ChaosPlan.make(nan_grad_steps=[1]))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    step = jgpt.make_train_step(config, opt, mesh, loss_scaler=scaler, step_guard=guard,
                                chaos=chaos)
    state, gstate = opt.init(params), guard.init()
    small = [scaler.init()] if scaled else []
    tok, tgt = (jnp.asarray(a) for a in _batch())
    losses, scales = [], []
    for _ in range(STEPS):
        out = step(params, state, *small, gstate, tok, tgt)
        params, state = out[0], out[1]
        if scaled:
            small = [out[2]]
            scales.append(float(out[2].loss_scale))
        gstate, loss = out[-2], out[-1]
        losses.append(float(loss))
    return tree, {"losses": losses, "scales": scales, "adam_step": int(state.step),
                  "guard": guard.state_dict(gstate)}


def _port_run(tree, scaled):
    config = tgpt.GPTConfig(**TINY, compute_dtype=torch.float32)
    params = tgpt.params_from_numpy(tree, config, device="cpu", keep_fp32=True)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt, guard = FusedAdam(lr=1e-2), StepGuard(3)
    scaler = DynamicLossScaler(init_scale=2.0 ** 8, hysteresis=1) if scaled else None
    chaos = C.ChaosMonkey(C.ChaosPlan.make(nan_grad_steps=[1]))
    step = train_gpt.make_train_step(opt, config, loss_scaler=scaler, step_guard=guard,
                                     chaos=chaos)
    assert isinstance(step, CapturedStep)
    state, gstate = opt.init(params), guard.init("cpu")
    small = [scaler.init("cpu")] if scaled else []
    tok, tgt = (torch.from_numpy(a) for a in _batch())
    losses, scales, snaps = [], [], []
    for _ in range(STEPS):
        snaps.append([p.detach().clone() for p in tree_leaves(params)])
        losses.append(float(step(params, state, *small, gstate, tok, tgt)))
        if scaled:
            scales.append(float(small[0].loss_scale))
    snaps.append([p.detach().clone() for p in tree_leaves(params)])
    return {"losses": losses, "scales": scales, "adam_step": int(state.step),
            "guard": guard.state_dict(gstate), "snaps": snaps}


@pytest.mark.parametrize("scaled", [False, True], ids=["guard", "scaler_and_guard"])
def test_grad_fault_in_the_captured_step_skips_exactly_the_planned_step(scaled):
    tree, want = _jax_run(scaled)
    got = _port_run(tree, scaled)
    assert got["guard"] == want["guard"] == {"step": STEPS, "consecutive_bad": 0,
                                             "total_skipped": 1}
    assert got["adam_step"] == want["adam_step"] == STEPS - 1
    assert got["scales"] == want["scales"]
    for i, (g, w) in enumerate(zip(got["losses"], want["losses"], strict=True)):
        assert math.isnan(g) == math.isnan(w) == (i == 1)
        if not math.isnan(w):
            assert abs(g - w) <= BAND * abs(w), (got["losses"], want["losses"])
    # the planned step changed nothing; the others moved the params
    assert all(torch.equal(a, b) for a, b in zip(got["snaps"][1], got["snaps"][2]))
    assert not all(torch.equal(a, b) for a, b in zip(got["snaps"][2], got["snaps"][3]))


def test_chaos_without_a_guard_is_refused():
    config = tgpt.GPTConfig(**TINY, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="needs step_guard"):
        train_gpt.make_train_step(FusedAdam(lr=1e-2), config,
                                  chaos=C.ChaosMonkey(C.ChaosPlan.make(nan_grad_steps=[0])))


def test_grad_fault_in_the_pipelined_step():
    """``make_pp_train_step`` over a one-rank gloo group (2 microbatches):
    the planned step is skipped with params bitwise unchanged, every
    other step moves them, and the guard state is what JAX's
    ``StepGuard`` gives for the vote [finite, NaN, finite]."""
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    multiproc.initialize_distributed("cpu")
    try:
        ps.initialize_model_parallel(1, 1)
        config = tgpt.GPTConfig(**TINY, compute_dtype=torch.float32)
        params = tgpt.params_from_numpy(tgpt._init_numpy(config, 0), config, "cpu",
                                        keep_fp32=True)
        opt, guard = FusedAdam(lr=1e-2), StepGuard(3)
        chaos = C.ChaosMonkey(C.ChaosPlan.make(nan_grad_steps=[1]))
        step = tgpt.make_pp_train_step(config, opt, 2, step_guard=guard, chaos=chaos,
                                       dp_group=ps.get_data_parallel_group())
        state, gstate = opt.init(params), guard.init("cpu")
        tok, tgt = (torch.from_numpy(a) for a in _batch())
        losses, snaps = [], []
        for _ in range(3):
            snaps.append([p.detach().clone() for p in tree_leaves(params)])
            losses.append(float(step(params, state, gstate, tok, tgt)))
        snaps.append([p.detach().clone() for p in tree_leaves(params)])
    finally:
        multiproc.destroy_distributed()
    jg = JaxStepGuard(3)
    js = jg.init()
    for ok in (True, False, True):
        js = jg.update(js, jnp.bool_(ok))
    assert guard.state_dict(gstate) == jg.state_dict(js)
    assert [math.isnan(x) for x in losses] == [False, True, False]
    assert all(torch.equal(a, b) for a, b in zip(snaps[1], snaps[2]))
    assert not all(torch.equal(a, b) for a, b in zip(snaps[0], snaps[1]))
    assert int(state.step) == 2


def _tree():
    return {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.ones(5, np.float32)}


@pytest.mark.parametrize("site,budget", [("ckpt.write", 2), ("ckpt.read", 2),
                                         ("ckpt.read", 10)])
def test_check_io_at_the_checkpoint_seam(tmp_path, monkeypatch, site, budget):
    """Each retried attempt passes the seam: a budget under the retry
    cap is retried through, one over it raises ``ChaosIOError``; the
    ``injected`` counts are the JAX package's."""
    monkeypatch.setattr(tckpt, "_IO_BACKOFF_BASE", 0.0)
    monkeypatch.setattr(jckpt, "_IO_BACKOFF_BASE", 0.0)
    tree = _tree()
    clean = tmp_path / "clean.ckpt"
    tckpt.save_checkpoint(clean, {k: torch.from_numpy(v) for k, v in tree.items()})
    results = {}
    for name, mod, ck in (("port", C, tckpt), ("jax", J, jckpt)):
        path = tmp_path / f"{name}.ckpt"
        if site == "ckpt.read":  # each package reads a file it wrote
            if name == "port":
                shutil.copy(clean, path)
            else:
                jckpt.save_checkpoint(path, tree)
        m = mod.ChaosMonkey(mod.ChaosPlan.make(io_failures={site: budget}))
        with m.active():
            try:
                if site == "ckpt.write":
                    arg = tree if name == "jax" else {k: torch.from_numpy(v)
                                                      for k, v in tree.items()}
                    ck.save_checkpoint(path, arg)
                else:
                    ck.load_checkpoint(path)
                results[name] = ("ok", dict(m.injected))
            except OSError as e:
                results[name] = (type(e).__name__, dict(m.injected))
    assert results["port"] == results["jax"]
    assert results["port"][0] == ("ok" if budget <= tckpt._IO_RETRIES else "ChaosIOError")
    if site == "ckpt.write":
        assert (tmp_path / "port.ckpt").read_bytes() == clean.read_bytes()


def test_corrupt_newest_checkpoint_flips_the_jax_bytes(tmp_path):
    for name in ("port", "jax"):
        d = tmp_path / name
        d.mkdir()
        for s in (1, 2):
            tckpt.save_checkpoint(d / f"step_{s:08d}.ckpt",
                                  {"w": torch.full((64,), float(s))})
    got = C.corrupt_newest_checkpoint(tmp_path / "port")
    want = J.corrupt_newest_checkpoint(tmp_path / "jax")
    assert got.endswith("step_00000002.ckpt") and want.endswith("step_00000002.ckpt")
    assert (tmp_path / "port" / "step_00000002.ckpt").read_bytes() == \
        (tmp_path / "jax" / "step_00000002.ckpt").read_bytes()
    bad = tckpt.probe_checkpoint_dir(tmp_path / "port")
    assert bad is not None and bad.path.endswith("step_00000002.ckpt")
    with pytest.raises(FileNotFoundError):
        C.corrupt_newest_checkpoint(tmp_path / "empty")


def test_run_controller_delivers_the_planned_kill(tmp_path):
    m = C.ChaosMonkey(C.ChaosPlan.make(kill_at={1: 2}, wedge_step_at=1,
                                       wedge_step_seconds=0.01))
    ctl = elastic.ElasticRunController(tmp_path, None, world_size=2, chaos=m, rank=1)
    ctl.on_step(0)
    ctl.on_step(1)
    with pytest.raises(C.ChaosHostKilled) as ei:
        ctl.on_step(2)
    assert ei.value.code == elastic.EXIT_KILLED == 137
    assert m.injected == {"wedge_step": 1, "kill:1": 1}
    # rank 0's controller is not on the plan
    elastic.ElasticRunController(tmp_path, None, world_size=2, chaos=m, rank=0).on_step(2)


@pytest.mark.parametrize("kw", [{"kernel_failures": {"flash_fwd": 1}},
                                {"wedge_collective_rank": 0, "wedge_collective_at_step": 1,
                                 "wedge_collective_seconds": 1.0}],
                         ids=["kernel_failure", "collective_wedge"])
def test_unportable_plans_raise_at_construction(kw):
    J.ChaosPlan.make(**kw)  # the JAX package injects these
    with pytest.raises(ValueError, match="is refused: (the port has no kernel fallback|the "
                                         "JAX step stalls one rank)"):
        C.ChaosPlan.make(**kw)
    with pytest.raises(ValueError, match="refused"):
        C.ChaosPlan(**{k: (dict(v) if isinstance(v, dict) else v) for k, v in kw.items()})
    assert not hasattr(C, "check_kernel")
    assert json.dumps(C.KERNEL_FAILURE_REASON)
