"""The port's uniformity seam (``apex_tpu_torch.resilience.uniformity``)
against the JAX package's, on the CPU.

- ``uniform_digest`` gives the JAX package's digest for every value
  (dicts in any key order, sets, bytes, numpy scalars and arrays, nested
  structures), so both packages' records of one decision agree;
- record-only ``assert_uniform``, ``check_uniform`` through an injected
  gather (one divergent rank; a tag some ranks never recorded),
  providers and the ``UniformityMonitor``: the same decisions and the
  same ``UniformityError`` (tag and per-rank views) as the JAX package;
- the call sites: the ZeRO engine records ``zero.bucket_plan`` (its plan
  fingerprint) and the serving scheduler ``serve.scheduler_config``;
- a real world of 2 under gloo (``parallel.multiproc.launch``, one
  process a rank, the torchrun environment), where rank 1 builds its
  ZeRO bucket plan with another bucket cap: the default gather
  (``all_gather_object`` over the world) makes every rank raise
  ``UniformityError`` naming ``zero.bucket_plan`` within the world's
  60 s limit, and the same world with equal plans passes.

All exact: digests are strings.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from apex_tpu.resilience import uniformity as JU

from apex_tpu_torch.resilience import uniformity as U

REPO = Path(__file__).resolve().parent.parent

VALUES = {
    "dict": {"b": [2, 3], "a": 1},
    "nested": {"decode": {"max_batch": 8, "dtype": "bfloat16"}, "model": [12, 768, None]},
    "set": {3, 1, 2},
    "bytes": b"\x00\xff",
    "np_int": np.int64(7),
    "np_array": np.arange(6, dtype=np.int32).reshape(2, 3),
    "float": 1.5,
    "plan": {"world": 2, "cap_bytes": 1 << 20, "model_mult": 1, "hier": None,
             "buckets": [["float32", 1024, 2048, 3]]},
}


@pytest.fixture(autouse=True)
def _isolated():
    U.reset_uniformity()
    JU.reset_uniformity()
    yield
    U.reset_uniformity()
    JU.reset_uniformity()


@pytest.mark.parametrize("name", sorted(VALUES))
def test_digest_is_the_jax_packages(name):
    assert U.uniform_digest(VALUES[name]) == JU.uniform_digest(VALUES[name])


def test_digest_of_torch_values_is_that_of_their_lists():
    assert U.uniform_digest(torch.arange(4)) == U.uniform_digest([0, 1, 2, 3])
    assert U.uniform_digest({1, 2, 3}) == U.uniform_digest({3, 2, 1})
    assert U.uniform_digest({"cap": 1 << 20}) != U.uniform_digest({"cap": 1 << 21})


def _views(n, mutate=None):
    def gather(payload):
        views = [dict(payload) for _ in range(n)]
        if mutate is not None:
            for rank, view in enumerate(views):
                mutate(view, rank)
        return views
    return gather


def _one_diverges(view, rank):
    if rank == 2:
        view["zero.bucket_plan"] = "deadbeefdeadbeef"


def _never_recorded(view, rank):
    if rank == 1:
        view.pop("serve.scheduler_config")


@pytest.mark.parametrize("case", ["agree", "one_diverges", "never_recorded", "eager"])
def test_check_uniform_decides_as_jax(case):
    """Both packages record the same decisions and raise the same error
    (tag and views) through the same injected gather."""
    out = {}
    for mod in (U, JU):
        mod.reset_uniformity()
        mod.assert_uniform("zero.bucket_plan", VALUES["plan"])
        mod.assert_uniform("serve.scheduler_config", VALUES["nested"])
        mod.register_uniform("registry.engaged", lambda: {"flash": True})
        try:
            if case == "eager":
                mod.assert_uniform("x", 1, gather=_views(2, lambda v, r: v.update(x=str(r))))
            mutate = {"agree": None, "one_diverges": _one_diverges,
                      "never_recorded": _never_recorded}.get(case)
            out[mod] = ("ok", mod.check_uniform(gather=_views(4, mutate)))
        except mod.UniformityError as e:
            out[mod] = ("error", e.tag, e.views)
    assert out[U] == out[JU]
    assert out[U][0] == ("ok" if case == "agree" else "error")


def test_record_only_monitor_and_single_process():
    calls = []
    prev = U.install_gather(lambda p: calls.append(p) or [p])
    assert prev is None
    U.install_gather(None)
    U.assert_uniform("a", 1)  # records, gathers nothing
    assert not calls and U.recorded_decisions() == {"a": U.uniform_digest(1)}
    assert U.check_uniform() == {"a": U.uniform_digest(1)}  # no group: one view
    mon, jmon = U.UniformityMonitor(3, gather=_views(2)), JU.UniformityMonitor(3, gather=_views(2))
    for step in range(7):
        assert (mon.on_step(step) is None) == (jmon.on_step(step) is None)
    assert U.recorded_decisions()["uniformity.monitor_step"] == \
        JU.recorded_decisions()["uniformity.monitor_step"]
    with pytest.raises(ValueError, match="every_n_steps"):
        U.UniformityMonitor(0)


def test_scheduler_records_its_config():
    from apex_tpu_torch.inference import ContinuousBatchingScheduler, DecodeConfig, KVCacheConfig
    from apex_tpu_torch.models.gpt import GPTConfig, init_params

    config = GPTConfig(vocab_size=64, hidden_size=32, num_layers=1, num_attention_heads=4,
                       max_seq_len=32, position_embedding_type="rope",
                       compute_dtype=torch.float32)
    dcfg = DecodeConfig(cache=KVCacheConfig(num_pages=9, page_size=4, pages_per_seq=4,
                                            dtype=torch.float32),
                        max_batch=2, max_prompt_len=8)
    import dataclasses

    ContinuousBatchingScheduler(init_params(config, 0, device="cpu"), config, dcfg,
                                device="cpu", graphs=False)
    assert U.recorded_decisions()["serve.scheduler_config"] == U.uniform_digest(
        {"decode": dataclasses.asdict(dcfg), "model": dataclasses.asdict(config)})


CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from apex_tpu_torch.parallel import initialize_distributed, destroy_distributed
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.contrib.optimizers import DistributedFusedAdam
from apex_tpu_torch.resilience import uniformity as U
initialize_distributed("cpu")
ps.initialize_model_parallel(1, 1)
rank = dist.get_rank()
diverge = sys.argv[2] == "diverge"
params = {f"w{i}": torch.zeros(64 * 1024) for i in range(4)}
cap = 0.25 if (diverge and rank == 1) else 0.5
opt = DistributedFusedAdam(lr=1e-3, weight_decay=0.0, bucket_cap_mb=cap)
opt.init(params)
out = {"rank": rank, "recorded": sorted(U.recorded_decisions())}
try:
    U.check_uniform()
    out["result"] = "ok"
except U.UniformityError as e:
    out["result"] = "error"
    out["tag"] = e.tag
    out["views"] = e.views
print(json.dumps(out), flush=True)
destroy_distributed()
'''


@pytest.mark.parametrize("mode", ["diverge", "agree"])
def test_world_of_two_names_the_divergent_tag(mode, tmp_path):
    from apex_tpu_torch.parallel import multiproc

    script = tmp_path / "child.py"
    script.write_text(CHILD)
    procs = multiproc.launch([str(script), str(REPO), mode], 2, timeout=60.0)
    outs = [json.loads(p.stdout.strip().splitlines()[-1]) for p in procs]
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert "zero.bucket_plan" in o["recorded"]
        if mode == "diverge":
            assert o["result"] == "error" and o["tag"] == "zero.bucket_plan"
            assert o["views"][0] != o["views"][1]
        else:
            assert o["result"] == "ok"
