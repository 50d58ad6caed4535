"""The port's simple DDP driver (``apex_tpu_torch.distributed_data_parallel``)
against the JAX driver (``examples/simple/distributed/distributed_data_parallel.py``)
on the CPU.

- a gloo world of 2 (``parallel.multiproc.launch``, the ``torchrun``
  environment, a timeout of its own) against the JAX driver's
  ``shard_map`` step on a dp mesh of 2 CPU devices after its 60 steps:
  the weights within ``TOL`` = 1e-5 of their largest entry, the printed
  losses (steps 0, 15, 30, 45) within 1e-5 relative, both ranks'
  results equal, ``max |w - w_true| < 0.1``;
- a one-rank group in this process against the JAX step on one device;
- the data: the JAX driver's draws from ``RandomState(0)``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.optimizers import FusedSGD as JaxFusedSGD
from apex_tpu.parallel import allreduce_gradients as jax_allreduce_gradients

from apex_tpu_torch import distributed_data_parallel as tddp
from apex_tpu_torch.parallel import multiproc

REPO = Path(__file__).resolve().parent.parent
#: the weights (of their largest entry) and the losses (relative), fp32
TOL = 1e-5
WORLD_TIMEOUT = 180

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from apex_tpu_torch import distributed_data_parallel as d
r = d.run(d.build_args().parse_args(["--device", "cpu"]))
print("RESULT " + json.dumps({"losses": r["losses"], "w": r["w"].tolist(), "err": r["err"],
                              "world": r["world"]}))
"""


def jax_reference(n_devices):
    """The JAX driver's ``main`` on ``n_devices`` CPU devices: ``(w,
    losses by step)``."""
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("dp",))
    w_true, X, Y = tddp.data(n_devices)
    params = {"w": jnp.zeros((16, 1))}
    opt = JaxFusedSGD(lr=0.02, momentum=0.9)
    state = opt.init(params)

    def local_step(params, state, x, y):
        def loss_fn(p):
            return jnp.mean((x @ p["w"] - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        grads = jax_allreduce_gradients(grads, axis_name="dp")
        loss = jax.lax.pmean(loss, "dp")
        params, state = opt.update(grads, state, params)
        return params, state, loss

    step = jax.jit(jax.shard_map(local_step, mesh=mesh,
                                 in_specs=(P(), P(), P("dp"), P("dp")),
                                 out_specs=(P(), P(), P()), check_vma=False))
    losses = {}
    for i in range(tddp.STEPS):
        params, state, loss = step(params, state, jnp.asarray(X), jnp.asarray(Y))
        if i % 15 == 0:
            losses[i] = float(loss)
    return np.asarray(params["w"]), losses


def _check(w, losses, want_w, want_losses):
    assert np.abs(np.asarray(w) - want_w).max() <= TOL * np.abs(want_w).max()
    assert sorted(int(k) for k in losses) == sorted(want_losses) == [0, 15, 30, 45]
    for k, v in losses.items():
        np.testing.assert_allclose(v, want_losses[int(k)], rtol=TOL)


def test_data_is_the_jax_drivers():
    rng = np.random.RandomState(0)
    w_true, X, Y = tddp.data(2)
    np.testing.assert_array_equal(w_true, rng.randn(16, 1).astype(np.float32))
    np.testing.assert_array_equal(X, rng.randn(128, 16).astype(np.float32))
    assert X.shape == (128, 16) and Y.shape == (128, 1) and Y.dtype == np.float32


def test_world_of_two_matches_jax_shard_map():
    outs = multiproc.launch(["-c", CHILD, str(REPO)], 2, timeout=WORLD_TIMEOUT)
    results = [json.loads(next(ln for ln in o.stdout.splitlines()
                               if ln.startswith("RESULT "))[7:]) for o in outs]
    assert results[0] == results[1] and results[0]["world"] == 2
    assert "2 ranks, dp group (gloo)" in outs[0].stdout
    assert "max |w - w_true| = " in outs[0].stdout
    want_w, want_losses = jax_reference(2)
    _check(results[0]["w"], results[0]["losses"], want_w, want_losses)
    assert results[0]["err"] < 0.1


def test_one_rank_matches_jax(capsys):
    report = tddp.run(tddp.build_args().parse_args(["--device", "cpu"]))
    assert report["world"] == 1 and report["err"] < 0.1
    want_w, want_losses = jax_reference(1)
    _check(report["w"], report["losses"], want_w, want_losses)
    out = capsys.readouterr().out
    assert "step 45: loss" in out and "1 ranks, dp group (gloo)" in out


def test_module_runs_as_a_script():
    res = subprocess.run([sys.executable, "-m", "apex_tpu_torch.distributed_data_parallel",
                          "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=WORLD_TIMEOUT)
    assert res.returncode == 0, res.stderr
    assert "max |w - w_true|" in res.stdout
