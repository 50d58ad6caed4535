"""``torchrun -m apex_tpu_torch.pretrain_gpt --pp N [--tp T]`` on the CPU
(gloo) against ``examples/gpt/pretrain_gpt.py --tp 2 --pp 2`` on four
virtual CPU devices.

- The JAX trainer takes ``--tp 2 --pp 2 --steps 4`` from its
  ``PRNGKey(0)`` params; the port at world 4 (tp 2 x pp 2) resumes a
  step-0 file of those params in the JAX trainer's checkpoint tree and
  takes the same 4 steps over the same batches: losses within 1e-3
  relative of the JAX trainer's (bf16 compute in both, 2 microbatches in
  both; the band of ``tests/test_torch_pretrain_tp.py``).
- The port's own dp 2 x pp 2 run checkpoints (gathered whole over pp,
  with its layout) and resumes bitwise at step 2; a resume of that file
  at pp 4 raises as a layout change, naming its ROADMAP.md queue item.
  ``--zero --pp 2`` (dp 2 x pp 2, each rank's state the dp shard of its
  stage) takes the own run's 4 steps with its losses bitwise (at dp 2 the
  reduce-scatter and the DDP all-reduce add the same two addends, and the
  ZeRO update is FusedAdam's), and its elastic checkpoint refuses a
  resume at pp 4.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from apex_tpu_torch import pretrain_gpt

REPO = Path(__file__).resolve().parent.parent
SHAPE = ["--layers", "4", "--hidden", "32", "--heads", "4", "--vocab", "64", "--seq", "16",
         "--global-batch", "4"]
#: bf16 compute in both packages (the module docstring)
BAND = 1e-3


def _jax_start(devices, args):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    return subprocess.Popen([sys.executable, str(REPO / "examples/gpt/pretrain_gpt.py"),
                             *SHAPE, *args], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _losses(text):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"^step (\d+): loss=([-\d.]+)", text, re.M)}


def _torchrun_start(nproc, args, shape=SHAPE):
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc-per-node={nproc}", "-m", "apex_tpu_torch.pretrain_gpt",
                             "--device", "cpu", *shape, *args], cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={**os.environ, "OMP_NUM_THREADS": "1"})


def _report(proc, timeout=600, ok=True):
    out, err = proc.communicate(timeout=timeout)
    if not ok:
        return proc.returncode, out + err
    assert proc.returncode == 0, out[-3000:] + err[-5000:]
    line = next(ln for ln in out.splitlines() if ln.startswith('{"pretrain_gpt"'))
    return json.loads(line)["pretrain_gpt"], out


def _step0_file(path):
    """The JAX trainer's checkpoint tree at step 0 (its params from
    PRNGKey(0), FusedAdam's fresh state), written by the JAX package."""
    import jax
    import jax.numpy as jnp

    from apex_tpu import io as jio
    from apex_tpu.models.gpt import GPTConfig, init_params
    from apex_tpu.optimizers import FusedAdam

    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=4, num_attention_heads=4,
                    max_seq_len=16, compute_dtype=jnp.bfloat16)
    params = init_params(cfg, jax.random.PRNGKey(0))
    state = FusedAdam(lr=1e-3, weight_decay=0.01).init(params)
    jio.save_checkpoint(path, {"params": params, "state": state, "step": np.int64(0),
                               "scaler": None})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pretrain_pp")
    jax_proc = _jax_start(4, ["--tp", "2", "--pp", "2", "--steps", "4"])
    own = _torchrun_start(4, ["--pp", "2", "--steps", "4", "--checkpoint", str(d / "own"),
                              "--save-every", "2"])
    zero = _torchrun_start(4, ["--pp", "2", "--steps", "4", "--zero", "--checkpoint",
                               str(d / "zero"), "--save-every", "2"])
    _step0_file(d / "step0.ckpt")
    port = _torchrun_start(4, ["--tp", "2", "--pp", "2", "--steps", "4", "--resume",
                               str(d / "step0.ckpt")])
    text, _ = jax_proc.communicate(timeout=600)
    assert jax_proc.returncode == 0, text[-4000:]
    full, full_out = _report(own)
    ck = d / "own" / "step_00000002.ckpt"
    resumed = _torchrun_start(4, ["--pp", "2", "--steps", "2", "--resume", str(ck)])
    other_pp = _torchrun_start(4, ["--pp", "4", "--steps", "1", "--resume", str(ck)])
    zero_rep = _report(zero)
    zero_other = _torchrun_start(4, ["--pp", "4", "--zero", "--steps", "1", "--resume",
                                     str(d / "zero")])
    return {"jax": _losses(text), "port": _report(port), "own": (full, full_out),
            "resumed": _report(resumed), "other_pp": _report(other_pp, ok=False),
            "zero": zero_rep, "zero_other_pp": _report(zero_other, ok=False)}


def test_tp2_pp2_matches_the_jax_trainer(runs):
    want = runs["jax"]
    report, out = runs["port"]
    assert sorted(want) == [0, 1, 2, 3]
    assert "mesh: dp=1 pp=2 tp=2 (4 devices)" in out and "resumed at step 0" in out
    assert report["tp"] == 2 and report["pp"] == 2 and report["micro_batches"] == 2
    assert report["steps"] == [0, 1, 2, 3]
    rel = {s: abs(g - want[s]) / abs(want[s]) for s, g in zip(report["steps"], report["losses"])}
    assert max(rel.values()) <= BAND, (report["losses"], want, rel)


def test_own_pp_checkpoint_resumes_bitwise(runs):
    full, out = runs["own"]
    part, part_out = runs["resumed"]
    assert "mesh: dp=2 pp=2 tp=1 (4 devices)" in out
    assert full["pp"] == 2 and full["dp"] == 2 and full["steps"] == [0, 1, 2, 3]
    assert all(np.isfinite(full["losses"]))
    assert "resumed at step 2" in part_out and part["steps"] == [2, 3]
    assert part["losses"] == full["losses"][2:]


def test_a_change_of_pp_and_zero_with_pp_raise(runs):
    rc, text = runs["other_pp"]
    assert rc != 0 and re.search(r"saved at tp=1, pp=2; resuming it at tp=1, pp=4 .*"
                                 r"ROADMAP.md queue 1 item 13", text), text[-3000:]
    # --zero --pp 2 runs: the own run's losses, bitwise; its elastic
    # checkpoint refuses a pp change, as the reference's controller does
    zero, zero_out = runs["zero"]
    full, _ = runs["own"]
    assert "mesh: dp=2 pp=2 tp=1 (4 devices)" in zero_out and zero["zero"]
    assert zero["losses"] == full["losses"]
    rc, text = runs["zero_other_pp"]
    assert rc != 0 and "data-parallel-only" in text, text[-3000:]
