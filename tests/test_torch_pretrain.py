"""``python -m apex_tpu_torch.pretrain_gpt`` on the CPU, at a tiny size,
and its resume from the JAX package's trainer.

- JAX ``make_train_step`` (FusedAdam on a 1-device mesh, fp32 compute)
  takes 3 steps and saves the reference driver's checkpoint tree
  (``{"params", "state": AdamState, "step", "scaler"}``) with its
  ``save_checkpoint``; the port loads it (``load_checkpoint`` with a
  template, ``train_state_from_numpy``) and takes steps 4-6, whose
  losses are held to JAX's uninterrupted steps 4-6 within 1e-5
  relative, the fp32 band of tests/test_torch_amp_training.py; and the
  driver resumes from that same file;
- the driver: a resume from a step's checkpoint is bitwise equal to the
  uninterrupted run (bf16, fp16 with its scaler, the fused CE head);
  telemetry and tracing on and off give bitwise equal losses; the
  metrics, goodput and trace files it leaves; a simulated preemption
  saves at the step it reached and stops, and the same command then
  finishes bitwise equal; ``--keep`` pruning; the ``--data`` token file;
  no host read of a tensor value anywhere in a run (the dispatch-mode
  guard of tests/test_torch_graphs.py); the flags once refused, which now
  run (``--supervise`` through ``main``, the ``--chaos-*`` faults);
- data parallelism and ZeRO: ``--zero`` at world 1 (a one-rank gloo
  group in this process) gives losses bitwise equal to FusedAdam's, and
  resumes bitwise; ``examples/gpt/pretrain_gpt.py --zero`` at dp 2 on two
  virtual devices (wide, and ``--grad-sync-dtype int8``) takes 6 steps,
  saving its elastic checkpoint at step 3; ``torchrun --nproc-per-node 2
  -m apex_tpu_torch.pretrain_gpt --device cpu --zero`` resumes that JAX
  checkpoint (params, sharded state and residuals carried across) and
  takes steps 3-5, and the port at world 1 resumes it too (reshard
  2 -> 1) beside the JAX package's own dp 1 resume: losses within 1e-3
  relative (bf16 compute: XLA's bf16 matmuls and the port's plain flash
  and CE versions round otherwise; both packages' fp32 optimizer math is
  bitwise, tests/test_torch_zero.py).
"""

import json
import math
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from apex_tpu.io import checkpoint as jckpt
from apex_tpu.models import gpt as jgpt
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam

from apex_tpu_torch import io, pretrain_gpt, resilience, train_gpt
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.observability import metrics
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.optimizers.tree import tree_leaves

REPO = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--layers", "2", "--hidden", "32", "--heads", "4",
        "--vocab", "64", "--seq", "16", "--global-batch", "4"]
#: the fp32 band of tests/test_torch_amp_training.py
BAND = 1e-5


def _run(argv, capsys=None):
    """``pretrain_gpt.run`` on ``TINY + argv`` in its own metrics scope;
    returns ``(report, printed lines)``."""
    args = pretrain_gpt.build_args().parse_args(TINY + list(argv))
    with metrics.MetricsScope():
        report = pretrain_gpt.run(args)
    out = capsys.readouterr().out.splitlines() if capsys is not None else []
    return report, out


# ------------------------------------------------ JAX 3 steps -> port 4-6
def _batches(n, vocab=64, batch=4, seq=16):
    rng = np.random.RandomState(11)
    out = []
    for _ in range(n):
        tok = rng.randint(0, vocab, size=(batch, seq + 1))
        out.append((tok[:, :-1], tok[:, 1:]))
    return out


def test_jax_three_steps_then_port_resumes(tmp_path, capsys):
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_attention_heads=4,
               max_seq_len=16, checkpoint_layers=True, use_flash_attention=True)
    jconfig = jgpt.GPTConfig(**cfg, compute_dtype=jnp.float32)
    params = jgpt.init_params(jconfig, jax.random.PRNGKey(0))
    opt = JaxFusedAdam(lr=1e-2, weight_decay=0.01)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    step = jgpt.make_train_step(jconfig, opt, mesh)
    state = opt.init(params)
    batches = _batches(6)
    want, path = [], tmp_path / "step_00000003.ckpt"
    for i, (tok, tgt) in enumerate(batches):
        params, state, loss = step(params, state, jnp.asarray(tok), jnp.asarray(tgt))
        want.append(float(loss))
        if i == 2:  # the reference driver's ckpt_tree after step 3
            jckpt.save_checkpoint(path, {"params": params, "state": state,
                                         "step": np.int64(3), "scaler": None})

    config = tgpt.GPTConfig(**cfg, compute_dtype=torch.float32)
    fresh = tgpt.init_params(config, 0, "cpu", keep_fp32=True)
    topt = FusedAdam(lr=1e-2, weight_decay=0.01)
    template = {"params": fresh, "state": topt.init(fresh), "step": np.int64(0), "scaler": None}
    tree = io.load_checkpoint(path, template=template)
    tparams, tstate, sstate, start = tgpt.train_state_from_numpy(tree, config, "cpu")
    assert start == 3 and sstate is None and int(tstate.step) == 3
    for leaf in tree_leaves(tparams):
        leaf.requires_grad_(True)
    tstep = train_gpt.make_train_step(topt, config)
    got = [float(tstep(tparams, tstate, torch.from_numpy(tok), torch.from_numpy(tgt)))
           for tok, tgt in batches[3:]]
    for g, w in zip(got, want[3:], strict=True):
        assert abs(g - w) <= BAND * abs(w), (got, want[3:])
    assert int(tstate.step) == 6

    # the driver resumes from the JAX package's file (at its own bf16)
    report, out = _run(["--resume", str(path), "--steps", "2"], capsys)
    assert "resumed at step 3" in out and report["start_step"] == 3
    assert report["steps"] == [3, 4] and all(math.isfinite(x) for x in report["losses"])


# ------------------------------------------------------- the port's driver
@pytest.mark.parametrize("flags", [[], ["--fp16"], ["--fused-ce"]],
                         ids=["bf16", "fp16", "fused_ce"])
def test_resume_is_bitwise_the_uninterrupted_run(tmp_path, capsys, flags):
    full, _ = _run(flags + ["--steps", "6", "--checkpoint", str(tmp_path / "a"),
                            "--save-every", "3"], capsys)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "step_00000003.ckpt", "step_00000006.ckpt"]
    part, out = _run(flags + ["--resume", str(tmp_path / "a" / "step_00000003.ckpt"),
                              "--steps", "3"], capsys)
    assert "resumed at step 3" in out and part["steps"] == [3, 4, 5]
    assert part["losses"] == full["losses"][3:]
    if "--fp16" in flags:
        assert part["loss_scales"] == full["loss_scales"][3:]
        assert all(s == 4096.0 for s in full["loss_scales"])
        assert any(ln.startswith("step 4: loss=") and ln.endswith("scale=4096") for ln in out)
    # a directory resumes from its newest valid file
    last, out = _run(flags + ["--resume", str(tmp_path / "a"), "--steps", "1"], capsys)
    assert last["start_step"] == 6
    for w in full["writes"]:
        assert io.validate_checkpoint(w["path"]) and w["bytes"] > 0 and w["seconds"] >= 0


def test_telemetry_and_tracing_leave_losses_bitwise_and_write_their_files(tmp_path, capsys):
    plain, _ = _run(["--steps", "6"], capsys)
    m, t = tmp_path / "m", tmp_path / "t"
    on, out = _run(["--steps", "6", "--metrics-dir", str(m), "--trace-dir", str(t),
                    "--telemetry-every", "3", "--checkpoint", str(tmp_path / "c"),
                    "--save-every", "3"], capsys)
    assert on["losses"] == plain["losses"]
    # two windows; each window's loss_mean is the mean of its steps' losses
    lines = [json.loads(x) for x in (m / "metrics.jsonl").read_text().splitlines()]
    means = [x["value"] for x in lines if x["metric"] == "apex_train_loss"]
    assert [x["window_end_step"] for x in lines if x["metric"] == "apex_train_loss"] == [3, 6]
    for k, mean in enumerate(means):
        want = float(np.mean(np.float32(plain["losses"][3 * k:3 * k + 3])))
        assert abs(mean - want) <= 1e-6 * abs(want)
    assert [ln for ln in out if ln.startswith("telemetry[")][0].startswith("telemetry[3]:")
    assert (m / "metrics.prom").read_text().count("apex_train_steps_total{") == 1
    rep = json.loads((m / "goodput_report.json").read_text())
    assert abs(sum(rep["fractions"].values()) - 1.0) < 1e-6 and rep["steps"] == 6
    trace = json.loads(next(t.glob("trace_gpt_*.json")).read_text())
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count("train.step.dispatch") == 6
    assert {"train.data_wait", "train.telemetry_fetch", "train.checkpoint_save"} <= set(names)
    assert next(t.glob("spans_gpt_*.jsonl")).exists() and next(t.glob("flightrec_*.json"))
    assert any(ln.startswith("goodput: ") for ln in out)
    assert any(ln.startswith("trace: ") for ln in out)


class _PreemptAt(resilience.PreemptionHandler):
    """The preemption notice lands while the step after ``polls`` polls
    runs (``simulate``, as a SIGTERM's handler marks the flag)."""

    polls = 2

    @property
    def preempted(self):
        _PreemptAt.polls -= 1
        if _PreemptAt.polls == 0:
            self.simulate("signal SIGTERM")
        return super().preempted


def test_simulated_preemption_saves_stops_and_resumes_bitwise(tmp_path, capsys, monkeypatch):
    full, _ = _run(["--steps", "6"], capsys)
    argv = ["--steps", "6", "--checkpoint", str(tmp_path / "c"), "--auto-resume",
            "--save-every", "4"]
    monkeypatch.setattr(resilience, "PreemptionHandler", _PreemptAt)
    _PreemptAt.polls = 2
    first, out = _run(argv, capsys)
    monkeypatch.undo()
    assert "preempted (signal SIGTERM) after step 1; rerun the same command to resume" in out
    assert first["preempted"] and first["steps_done"] == 2 and first["steps"] == [0, 1]
    assert [p.name for p in (tmp_path / "c").glob("*.ckpt")] == ["step_00000002.ckpt"]
    again, out = _run(argv, capsys)
    assert "resumed at step 2" in out and again["start_step"] == 2
    assert first["losses"] + again["losses"][:4] == full["losses"]


@pytest.mark.parametrize("slow_disk", [False, True], ids=["fast", "slow_disk"])
def test_keep_prunes_to_the_newest_three(tmp_path, capsys, monkeypatch, slow_disk):
    """With a disk slower than the steps, writes are still queued when
    the next save prunes: the files queued count among the newest."""
    if slow_disk:
        from apex_tpu_torch.io import async_checkpoint

        write = async_checkpoint.save_checkpoint

        def slow(path, tree):
            time.sleep(0.2)
            write(path, tree)

        monkeypatch.setattr(async_checkpoint, "save_checkpoint", slow)
    _run(["--steps", "6", "--checkpoint", str(tmp_path), "--save-every", "1", "--keep", "1"],
         capsys)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000004.ckpt", "step_00000005.ckpt", "step_00000006.ckpt"]


def test_data_token_file(tmp_path, capsys):
    tokens = np.random.RandomState(3).randint(0, 64, size=17 * 40).astype(np.uint16)
    path = tmp_path / "tokens.bin"
    tokens.tofile(path)
    report, _ = _run(["--steps", "3", "--data", str(path)], capsys)
    assert len(report["losses"]) == 3 and all(math.isfinite(x) for x in report["losses"])
    tokens[5] = 64  # outside the vocab: the batch that holds it fails loudly
    tokens.tofile(path)
    with pytest.raises(ValueError, match="outside \\[0, vocab=64\\)"):
        _run(["--steps", "1", "--data", str(path)], capsys)
    tokens[:17 * 3].tofile(path)
    with pytest.raises(ValueError, match="need at least one global batch"):
        _run(["--steps", "1", "--data", str(path)], capsys)


_HOST_READS = (torch.ops.aten._local_scalar_dense, torch.ops.aten.item,
               torch.ops.aten.nonzero)


class NoHostReads(TorchDispatchMode):
    """Raises on every op that reads a tensor's value on the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _HOST_READS:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


def test_no_host_read_anywhere_in_a_run(tmp_path, capsys):
    argv = ["--steps", "4", "--fp16", "--metrics-dir", str(tmp_path / "m"),
            "--telemetry-every", "2", "--checkpoint", str(tmp_path / "c"), "--save-every", "2"]
    with NoHostReads():
        _run(argv, capsys)
        _run(argv[:-4] + ["--resume", str(tmp_path / "c" / "step_00000002.ckpt")], capsys)
    with NoHostReads(), pytest.raises(AssertionError, match="host read"):
        float(torch.ones(()))


@pytest.mark.parametrize("flag", [["--tp", "1"], ["--pp", "2"], ["--micro-batches", "4"],
                                  ["--sequence-parallel"], ["--supervise"],
                                  ["--chaos-kill-at-step", "1"], ["--chaos-wedge-step", "1"],
                                  ["--chaos-wedge-secs", "5"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_unported_flags_raise_with_their_queue_item(flag, capsys):
    if flag[0] in ("--tp", "--sequence-parallel", "--micro-batches"):
        # ported: they run here at world 1 (tp 2 and dp 2 x tp 2 under
        # torchrun in tests/test_torch_pretrain_tp.py; pp 2 with its
        # micro-batches in tests/test_torch_pretrain_pp.py); at pp 1
        # --micro-batches changes nothing, as in the reference
        report, out = _run(flag + ["--steps", "2"], capsys)
        assert "mesh: dp=1 pp=1 tp=1 (1 devices)" in out and report["tp"] == 1
        assert report["pp"] == 1 and report["micro_batches"] is None
        assert report["sequence_parallel"] == (flag[0] == "--sequence-parallel")
        assert all(math.isfinite(x) for x in report["losses"])
        return
    if flag[0] == "--pp":
        # ported: one rank does not split into two stages, as the JAX
        # mesh refuses it (pp 2 under torchrun in
        # tests/test_torch_pretrain_pp.py)
        with pytest.raises(RuntimeError, match=r"world size \(1\) is not divisible"):
            _run(flag + ["--steps", "1"])
        return
    if flag[0] == "--supervise":
        # ported: main() runs the command as a supervised child (the round
        # trip is in tests/test_torch_supervisor.py); run() trains in this
        # process and refuses it, and a checkpointing run must auto-resume
        with pytest.raises(ValueError, match=r"call main\(\), not run\(\)"):
            _run(flag + ["--steps", "1"])
        with pytest.raises(SystemExit, match="--supervise needs --auto-resume"):
            pretrain_gpt.main(TINY + flag + ["--checkpoint", "/nonexistent/ck"])
        return
    if flag[0] == "--chaos-kill-at-step":
        # ported: rank 0 dies hard at step 1 (exit 137, no save)
        from apex_tpu_torch.resilience import ChaosHostKilled

        with pytest.raises(ChaosHostKilled) as ei:
            _run(flag + ["--steps", "3"])
        assert ei.value.code == 137 and (ei.value.rank, ei.value.step) == (0, 1)
        return
    # ported: the wedge sleeps step 1's dispatch (--chaos-wedge-secs, 120
    # by default); with no wedge step the seconds alone do nothing
    extra = ["--chaos-wedge-secs", "0.3"] if flag[0] == "--chaos-wedge-step" else []
    t0 = time.monotonic()
    report, _ = _run(flag + extra + ["--steps", "2"], capsys)
    assert report["steps_done"] == 2 and all(math.isfinite(x) for x in report["losses"])
    assert (time.monotonic() - t0 >= 0.3) or flag[0] == "--chaos-wedge-secs"


def test_refusals():
    with pytest.raises(SystemExit, match="--auto-resume needs --checkpoint"):
        _run(["--auto-resume"])
    with pytest.raises(SystemExit, match="--telemetry-every"):
        _run(["--telemetry-every", "0"])
    with pytest.raises(NotImplementedError, match="dots"):
        _run(["--remat-policy", "dots"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pretrain_gpt.main(["--steps", "1"])


def test_resume_from_nothing(tmp_path, capsys):
    with pytest.raises(FileNotFoundError):
        _run(["--resume", str(tmp_path)], capsys)
    (tmp_path / "step_00000002.ckpt").write_bytes(b"APEXTPU1 torn")
    with pytest.raises(io.AllCheckpointsTornError):
        _run(["--checkpoint", str(tmp_path), "--auto-resume", "--steps", "1"], capsys)


# ------------------------------------------------------- data parallel, ZeRO
#: the JAX driver's tiny shape, the same as TINY's model and batch
ZERO_SHAPE = ["--layers", "2", "--hidden", "32", "--heads", "4", "--vocab", "64", "--seq",
              "16", "--global-batch", "4"]
#: bf16 compute in both packages (see the module docstring)
ZERO_BAND = 1e-3


def _jax_pretrain(args, devices, timeout=600):
    """``examples/gpt/pretrain_gpt.py`` on ``devices`` virtual CPU devices,
    started (not waited for)."""
    import os
    import subprocess
    import sys

    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    return subprocess.Popen([sys.executable, str(REPO / "examples/gpt/pretrain_gpt.py"),
                             *ZERO_SHAPE, *args], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _jax_losses(proc, timeout=600):
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-4000:]
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step (\d+): loss=([-\d.]+)", out, re.M)}, out


def _torchrun_start(args, nproc=2):
    """``torchrun --standalone --nproc-per-node N -m apex_tpu_torch.pretrain_gpt``
    started (a rendezvous port of its own, so parallel test workers never
    collide)."""
    import os
    import subprocess
    import sys

    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc-per-node={nproc}", "-m", "apex_tpu_torch.pretrain_gpt",
                             "--device", "cpu", *ZERO_SHAPE, *args], cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})


def _torchrun_report(proc, timeout=600):
    """Rank 0's JSON report and the printed output of a started run."""
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-3000:] + err[-5000:]
    line = next(ln for ln in out.splitlines() if ln.startswith('{"pretrain_gpt"'))
    return json.loads(line)["pretrain_gpt"], out


def _torchrun(args, nproc=2):
    return _torchrun_report(_torchrun_start(args, nproc))


@pytest.fixture(scope="module")
def jax_zero(tmp_path_factory):
    """The JAX driver's ``--zero`` runs at dp 2 (wide and int8), 6 steps,
    elastic checkpoints at 3 and 6; then its dp 1 resume of the wide one
    from step 3.  Returns ``{name: (losses by step, checkpoint dir of
    step 3 alone)}``."""
    import shutil

    d = tmp_path_factory.mktemp("jax_zero")
    procs = {name: _jax_pretrain(["--steps", "6", "--zero", "--checkpoint", str(d / name),
                                  "--save-every", "3", *extra], 2)
             for name, extra in (("wide", []), ("int8", ["--grad-sync-dtype", "int8"]))}
    out = {}
    for name, proc in procs.items():
        losses, _ = _jax_losses(proc)
        assert sorted(losses) == list(range(6))
        step3 = d / f"{name}_at3"
        shutil.copytree(d / name / "step_00000003", step3 / "step_00000003")
        out[name] = (losses, step3)
    resumed, text = _jax_losses(_jax_pretrain(
        ["--steps", "3", "--zero", "--resume", str(out["wide"][1])], 1))
    assert "elastic reshard: dp=2 -> dp=1" in text
    out["wide_dp1"] = (resumed, out["wide"][1])
    return out


def _near(got, want):
    rel = {s: abs(got[s] - want[s]) / abs(want[s]) for s in want}
    assert max(rel.values()) <= ZERO_BAND, (got, want, rel)
    return rel


@pytest.mark.parametrize("wire", ["wide", "int8"])
def test_torchrun_world2_zero_resumes_the_jax_dp2_run(jax_zero, wire):
    losses, ck = jax_zero[wire]
    extra = ["--grad-sync-dtype", "int8"] if wire == "int8" else []
    report, out = _torchrun(["--zero", "--steps", "3", "--resume", str(ck), *extra])
    assert "mesh: dp=2 pp=1 tp=1 (2 devices)" in out and "resumed at step 3" in out
    assert report["dp"] == 2 and report["zero"] and report["steps"] == [3, 4, 5]
    _near(dict(zip(report["steps"], report["losses"])), {s: losses[s] for s in (3, 4, 5)})


def test_world1_zero_reshards_the_jax_dp2_checkpoint(jax_zero, capsys):
    want, ck = jax_zero["wide_dp1"]
    report, out = _run(["--zero", "--steps", "3", "--resume", str(ck)], capsys)
    assert "resumed at step 3 (elastic reshard: dp=2 -> dp=1)" in out
    _near(dict(zip(report["steps"], report["losses"])), want)


def test_zero_world1_is_fused_adam_bitwise_and_resumes(tmp_path, capsys):
    import shutil

    plain, _ = _run(["--steps", "4"], capsys)
    zero, out = _run(["--zero", "--steps", "4", "--checkpoint", str(tmp_path / "z"),
                      "--save-every", "2"], capsys)
    assert "mesh: dp=1 pp=1 tp=1 (1 devices)" in out
    assert zero["losses"] == plain["losses"] and zero["zero"]
    assert sorted(p.name for p in (tmp_path / "z").iterdir()) == ["step_00000002",
                                                                 "step_00000004"]
    shutil.rmtree(tmp_path / "z" / "step_00000004")
    part, out = _run(["--zero", "--steps", "2", "--resume", str(tmp_path / "z")], capsys)
    assert "resumed at step 2" in out and part["losses"] == zero["losses"][2:]
    with pytest.raises(ValueError, match="resume with --zero"):
        _run(["--checkpoint", str(tmp_path / "z"), "--auto-resume", "--steps", "1"], capsys)
    with pytest.raises(SystemExit, match="needs --zero"):
        _run(["--grad-sync-dtype", "int8"])


def test_torchrun_world2_ddp_and_quantized_wires_run():
    """Without --zero a world of 2 all-reduces the grads (the DDP sync);
    both fp8 wires run; rank 0 alone prints."""
    procs = [_torchrun_start(["--steps", "2", *extra])
             for extra in ([], ["--zero", "--grad-sync-dtype", "float8_e4m3fn"],
                           ["--zero", "--grad-sync-dtype", "float8_e5m2"])]
    for proc in procs:
        report, out = _torchrun_report(proc)
        assert report["dp"] == 2 and all(math.isfinite(x) for x in report["losses"])
        assert out.count('{"pretrain_gpt"') == 1 and out.count("mesh: dp=2") == 1
