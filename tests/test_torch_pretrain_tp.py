"""``torchrun -m apex_tpu_torch.pretrain_gpt --tp N [--sequence-parallel]``
on the CPU (gloo) against ``examples/gpt/pretrain_gpt.py --tp N`` on the
virtual CPU devices.

- The JAX trainer at tp 2 on 2 devices (dp 1), plain and with
  ``--sequence-parallel --fused-ce``, and at tp 2 on 4 devices (dp 2),
  takes 6 steps and saves its single-file checkpoint at step 3; the
  port at the same world and tp resumes that file (the whole tree,
  sliced to each rank by ``shard_params``) and takes steps 3-5: losses
  within 1e-3 relative of the JAX trainer's (bf16 compute in both:
  XLA's bf16 matmuls and the port's plain flash and CE versions round
  otherwise; the band of ``tests/test_torch_pretrain.py`` ``ZERO_BAND``).
- The port's own tp 2 checkpoint (gathered whole, with its layout)
  resumes bitwise at step 4 at the same tp; at tp 1 it raises as a
  layout change, naming its ROADMAP.md queue line.  ``--zero --tp 2``
  (dp 1, each rank's state the dp shard of its tp slice) takes the own
  run's steps with its losses bitwise (at dp 1 the ZeRO update is
  FusedAdam's), and its elastic checkpoint refuses a resume at tp 1.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from apex_tpu_torch import pretrain_gpt
from apex_tpu_torch.observability import metrics

REPO = Path(__file__).resolve().parent.parent
SHAPE = ["--layers", "2", "--hidden", "32", "--heads", "4", "--vocab", "64", "--seq", "16",
         "--global-batch", "4"]
#: bf16 compute in both packages (the module docstring)
BAND = 1e-3
#: the JAX trainer runs: name -> (devices, flags)
JAX_RUNS = {"tp2": (2, []), "tp2_sp_fce": (2, ["--sequence-parallel", "--fused-ce"]),
            "dp2_tp2": (4, [])}


def _jax_start(devices, args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    return subprocess.Popen([sys.executable, str(REPO / "examples/gpt/pretrain_gpt.py"),
                             *SHAPE, *args], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _losses(text):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step (\d+): loss=([-\d.]+)", text, re.M)}


def _torchrun_start(nproc, args):
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc-per-node={nproc}", "-m", "apex_tpu_torch.pretrain_gpt",
                             "--device", "cpu", *SHAPE, *args], cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})


def _report(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-3000:] + err[-5000:]
    line = next(ln for ln in out.splitlines() if ln.startswith('{"pretrain_gpt"'))
    return json.loads(line)["pretrain_gpt"], out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainer's runs (6 steps, a checkpoint at 3), then the port's
    resumes of their step-3 files; and the port's own tp 2 + SP run with
    saves at 4 beside its resume from step 4.  Returns ``{name: (JAX
    losses by step, port report, port output)}`` and the own run's
    pair."""
    d = tmp_path_factory.mktemp("pretrain_tp")
    jax_procs = {name: _jax_start(dev, ["--tp", "2", "--steps", "6", "--checkpoint",
                                        str(d / name), "--save-every", "3", *flags])
                 for name, (dev, flags) in JAX_RUNS.items()}
    own = _torchrun_start(2, ["--tp", "2", "--sequence-parallel", "--steps", "6",
                              "--checkpoint", str(d / "own"), "--save-every", "4"])
    zero = _torchrun_start(2, ["--tp", "2", "--sequence-parallel", "--steps", "6", "--zero",
                               "--checkpoint", str(d / "zero"), "--save-every", "4"])
    jax_out = {}
    for name, proc in jax_procs.items():
        text, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, text[-4000:]
        jax_out[name] = _losses(text)
        assert sorted(jax_out[name]) == list(range(6)), text[-2000:]
    port = {name: _torchrun_start(dev, ["--tp", "2", "--steps", "3", "--resume",
                                        str(d / name / "step_00000003.ckpt"), *flags])
            for name, (dev, flags) in JAX_RUNS.items()}
    full, full_out = _report(own)
    resumed = _report(_torchrun_start(2, ["--tp", "2", "--sequence-parallel", "--steps", "2",
                                          "--resume", str(d / "own" / "step_00000004.ckpt")]))
    out = {name: (jax_out[name], *_report(proc)) for name, proc in port.items()}
    out["own"] = ((full, full_out), resumed, d / "own")
    out["zero"] = (_report(zero), d / "zero")
    return out


@pytest.mark.parametrize("name", sorted(JAX_RUNS))
def test_port_resumes_the_jax_trainer_at_the_same_tp(runs, name):
    want, report, out = runs[name]
    devices = JAX_RUNS[name][0]
    assert f"mesh: dp={devices // 2} pp=1 tp=2 ({devices} devices)" in out
    assert "resumed at step 3" in out and out.count('{"pretrain_gpt"') == 1
    assert report["tp"] == 2 and report["dp"] == devices // 2 and report["steps"] == [3, 4, 5]
    assert report["sequence_parallel"] == ("--sequence-parallel" in JAX_RUNS[name][1])
    rel = {s: abs(g - want[s]) / abs(want[s]) for s, g in zip(report["steps"], report["losses"])}
    assert max(rel.values()) <= BAND, (report["losses"], want, rel)


def test_own_checkpoint_resumes_bitwise_at_the_same_tp(runs):
    (full, out), (part, part_out), _ = runs["own"]
    assert "mesh: dp=1 pp=1 tp=2 (2 devices)" in out
    assert full["tp"] == 2 and full["sequence_parallel"] and full["steps"] == list(range(6))
    assert "resumed at step 4" in part_out and part["steps"] == [4, 5]
    assert part["losses"] == full["losses"][4:]


def test_a_change_of_tp_and_zero_with_tp_raise(runs):
    ck = runs["own"][2] / "step_00000004.ckpt"
    args = pretrain_gpt.build_args().parse_args(
        ["--device", "cpu", *SHAPE, "--steps", "1", "--resume", str(ck)])
    with metrics.MetricsScope(), pytest.raises(ValueError,
                                               match="saved at tp=2.*ROADMAP.md queue 1 item 13"):
        pretrain_gpt.run(args)
    # --zero --tp 2 runs: the own run's losses, bitwise; its elastic
    # checkpoint refuses a tp change, as the reference's controller does
    (zero, zero_out), zero_dir = runs["zero"]
    (full, _), _, _ = runs["own"]
    assert "mesh: dp=1 pp=1 tp=2 (2 devices)" in zero_out and zero["zero"]
    assert zero["losses"] == full["losses"]
    args = pretrain_gpt.build_args().parse_args(
        ["--device", "cpu", *SHAPE, "--zero", "--steps", "1", "--resume", str(zero_dir)])
    with metrics.MetricsScope(), pytest.raises(ValueError, match="data-parallel-only"):
        pretrain_gpt.run(args)
