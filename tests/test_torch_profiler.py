"""The port's profiling ranges and trace capture (``apex_tpu_torch.utils
.profiler``) and its small helpers (``utils.misc``), on the CPU.

- the public names are the JAX package's (``apex_tpu.utils.profiler``,
  ``apex_tpu.utils.misc``);
- ``profile(logdir)`` writes a chrome trace into ``logdir``, and the
  ranges opened inside it nest: each inner range's interval lies inside
  its outer one's, with the ``.run_<id>.s<step>`` suffix when a step
  context is set; the stack form pushes and pops in order;
- ``start_profile`` twice, ``stop_profile`` and ``nvtx_range_pop``
  without a start or a push raise;
- DDP with ``prof=True`` puts its sync inside an ``allreduce_gradients``
  range (a one-rank gloo group), as the reference's
  ``distributed.py:363`` does;
- ``divide`` / ``ensure_divisibility`` equal the JAX package's.
"""

import json

import pytest
import torch

from apex_tpu.utils import misc as jmisc
from apex_tpu.utils import profiler as jprof

from apex_tpu_torch.observability import clear_step_context, set_step_context
from apex_tpu_torch.utils import misc, profiler


@pytest.fixture(autouse=True)
def _no_step_context():
    """Ranges carry the step context's suffix: start each case without one
    (a driver run earlier in the process may have set it)."""
    clear_step_context()
    yield
    clear_step_context()


def _events(logdir):
    files = list(logdir.glob("trace_*.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    return {e["name"]: e for e in events if e.get("ph") == "X"}


def test_public_names_are_the_jax_packages():
    assert sorted(profiler.__all__) == sorted(jprof.__all__)
    for name in ("divide", "ensure_divisibility"):
        assert hasattr(misc, name) and hasattr(jmisc, name)


def test_profile_writes_a_trace_whose_ranges_nest(tmp_path):
    with profiler.profile(str(tmp_path)):
        with profiler.nvtx_range("outer"):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
            with profiler.nvtx_range("inner"):
                x = x + 1
            profiler.nvtx_range_push("pushed")
            x = x * 2
            profiler.nvtx_range_pop()
    ev = _events(tmp_path)
    for name in ("outer", "inner", "pushed"):
        assert name in ev, sorted(ev)[:20]
    o, i, p = ev["outer"], ev["inner"], ev["pushed"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert o["ts"] <= p["ts"] and p["ts"] + p["dur"] <= o["ts"] + o["dur"]
    assert i["ts"] + i["dur"] <= p["ts"]


def test_ranges_carry_the_step_context(tmp_path):
    set_step_context(run_id="r7", step=3)
    try:
        with profiler.profile(str(tmp_path)):
            with profiler.nvtx_range("train.step"):
                torch.ones(4).sum()
    finally:
        clear_step_context()
    assert "train.step.run_r7.s3" in _events(tmp_path)


def test_misuse_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no profile running"):
        profiler.stop_profile()
    with pytest.raises(RuntimeError, match="without a matching push"):
        profiler.nvtx_range_pop()
    profiler.start_profile(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="already running"):
            profiler.start_profile(str(tmp_path))
    finally:
        assert profiler.stop_profile() == str(tmp_path)


def test_ddp_prof_wraps_the_sync_in_a_range(tmp_path):
    from apex_tpu_torch.parallel import DistributedDataParallel, multiproc
    from apex_tpu_torch.transformer import parallel_state as ps

    multiproc.initialize_distributed("cpu")
    ps.initialize_model_parallel(1, 1)
    try:
        grads = {"w": torch.ones(8), "b": torch.full((3,), 2.0)}
        with profiler.profile(str(tmp_path)):
            out = DistributedDataParallel(prof=True).sync(grads)
            plain = DistributedDataParallel().sync(grads)
    finally:
        multiproc.destroy_distributed()
    assert all(torch.equal(out[k], plain[k]) for k in grads)
    names = _events(tmp_path)
    assert "allreduce_gradients" in names


@pytest.mark.parametrize("n,d", [(12, 4), (12, 5), (7, 7)])
def test_divide_equals_jax(n, d):
    if n % d:
        for mod in (misc, jmisc):
            with pytest.raises(ValueError, match="not divisible"):
                mod.divide(n, d)
    else:
        assert misc.divide(n, d) == jmisc.divide(n, d)
