"""The port's serving fleet (``apex_tpu_torch.inference.fleet``) against
the JAX package's ``FleetFrontend``, on the CPU, in fp32 at T = 0.

Both fleets serve the same params (the JAX tree carried by
``params_from_numpy``) and the same requests under the same chaos plan,
each replica a scheduler of its package (the JAX one with its xla impls
and fp32 sampling dots).  In every scenario the port's completions (the
spliced streams, replays, hedges, the replica that finished each) and
the frontend's stats equal the JAX fleet's, and every stream is the
unkilled single-replica run's token for token:

- a replica killed mid-stream (exit-137 shape: replayed from the
  journal), killed through ``kill()``, and wedged (exit-75 shape:
  replayed from the ``serve.step_wedged`` manifest, its tokens spliced,
  one trace id joining both replicas' spans);
- the brownout ladder (best-effort shed before interactive is
  rejected, typed ``Overloaded`` with its retry-after);
- drain then restart with nothing rejected;
- one hedged retry for an interactive straggler (a shared manual clock),
  and never a second;
- prefix affinity and least-loaded placement, the health gate;
- ``serve.fleet_config`` in the uniformity seam, and a fleet whose
  processes disagree about one replica's config failing ``check_uniform``.

All exact: greedy decoding in fp32 gives the same tokens on both sides
(tests/test_torch_serving_v2.py holds the schedulers' completions equal).
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.inference import (
    ContinuousBatchingScheduler as JaxScheduler, DecodeConfig as JaxDecodeConfig,
    KVCacheConfig as JaxKVCacheConfig, Request as JaxRequest,
)
from apex_tpu.inference import fleet as jfleet
from apex_tpu.models import gpt as jgpt
from apex_tpu.resilience import chaos as jchaos
from apex_tpu.resilience import uniformity as JU

from apex_tpu_torch.inference import (
    ContinuousBatchingScheduler, DecodeConfig, KVCacheConfig, Request,
)
from apex_tpu_torch.inference import fleet as tfleet
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.observability import MetricsScope, tracing
from apex_tpu_torch.resilience import chaos as tchaos
from apex_tpu_torch.resilience import uniformity as U

VOCAB = 61
TINY = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_attention_heads=4,
            max_seq_len=128, position_embedding_type="rope", checkpoint_layers=False)
OPEN = dict(hedge_after_s=0.0, reject_queue_depth=10_000, be_shed_queue_depth=10_000)


@pytest.fixture(autouse=True)
def _isolated_seams():
    U.reset_uniformity()
    JU.reset_uniformity()
    yield
    U.reset_uniformity()
    JU.reset_uniformity()
    tracing.disable()


@pytest.fixture(scope="module")
def model():
    jcfg = jgpt.GPTConfig(**TINY, compute_dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**TINY, compute_dtype=torch.float32)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return {"jax": (jcfg, jp), "port": (tcfg, tp)}


PKG = {"jax": (jfleet, JaxRequest, jchaos), "port": (tfleet, Request, tchaos)}


def _sched(model, pkg, *, num_pages=40, page_size=4, pages_per_seq=16, max_batch=2,
           max_prompt=16, time_fn=None, **dk):
    cfg, params = model[pkg]
    cache = dict(num_pages=num_pages, page_size=page_size, pages_per_seq=pages_per_seq)
    common = dict(max_batch=max_batch, max_prompt_len=max_prompt, temperature=0.0, top_k=0,
                  base_seed=0, **dk)
    kw = {} if time_fn is None else {"time_fn": time_fn}
    if pkg == "jax":
        d = JaxDecodeConfig(cache=JaxKVCacheConfig(**cache, dtype=jnp.float32),
                            attn_impl="xla", sample_impl="xla", sample_dot_dtype=jnp.float32,
                            **common)
        return JaxScheduler(params, cfg, d, **kw)
    d = DecodeConfig(cache=KVCacheConfig(**cache, dtype=torch.float32), **common)
    return ContinuousBatchingScheduler(params, cfg, d, device="cpu", **kw)


def _fleet(model, pkg, *, n=2, config=None, time_fn=None, auto_restart=True, **dk):
    fleet = PKG[pkg][0]
    reps = [fleet.LocalReplica(f"r{i}", (lambda: _sched(model, pkg, time_fn=time_fn, **dk)),
                               **({} if time_fn is None else {"time_fn": time_fn}))
            for i in range(n)]
    fe = fleet.FleetFrontend(reps, config=config or fleet.RouterConfig(**OPEN),
                             auto_restart=auto_restart,
                             **({} if time_fn is None else {"time_fn": time_fn}))
    return fe.start()


def _reqs(seed, n, max_new=6, size=10):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, VOCAB, size=size).tolist(), max_new) for i in range(n)]


def _baseline(model, reqs):
    """The unkilled single-replica greedy streams of the port."""
    sched = _sched(model, "port", max_batch=max(4, len(reqs)), num_pages=120)
    for rid, prompt, new in reqs:
        sched.submit(Request(rid, list(prompt), new))
    return {c.rid: tuple(c.tokens) for c in sched.run_until_drained()}


def _view(fe, done):
    return ({c.rid: (tuple(c.tokens), c.replays, c.hedged, c.replica_id) for c in done},
            dict(fe.stats))


def _both(model, scenario):
    out = {pkg: scenario(pkg) for pkg in ("jax", "port")}
    assert out["port"] == out["jax"]
    return out["port"]


def test_kill_one_replica_mid_stream(model):
    reqs = _reqs(7, 6)
    want = _baseline(model, reqs)

    def run(pkg):
        fleet, req, chaos = PKG[pkg]
        monkey = chaos.ChaosMonkey(chaos.ChaosPlan.make(kill_replica_at={"r0": 3}))
        with monkey.active():
            fe = _fleet(model, pkg)
            for rid, prompt, new in reqs:
                fe.submit(req(rid, list(prompt), new))
            done = fe.run_until_drained()
        assert monkey.injected.get("kill_replica:r0") == 1
        assert fe.replicas["r0"].state == "serving" and fe.replicas["r0"].restarts == 1
        return _view(fe, done)

    comps, stats = _both(model, run)
    assert {rid: c[0] for rid, c in comps.items()} == want
    assert stats["replica_deaths"] == 1 and stats["replays"] >= 1
    assert any(c[1] for c in comps.values())


def test_direct_kill(model):
    reqs = _reqs(8, 3, max_new=5)
    want = _baseline(model, reqs)

    def run(pkg):
        fleet, req, _ = PKG[pkg]
        fe = _fleet(model, pkg, auto_restart=False)
        for rid, prompt, new in reqs:
            fe.submit(req(rid, list(prompt), new), replica_id="r0")
        fe.step()
        fe.replicas["r0"].kill()
        fe._on_replica_dead(fe.replicas["r0"], None, "kill")
        return _view(fe, fe.run_until_drained())

    comps, _ = _both(model, run)
    assert {rid: c[0] for rid, c in comps.items()} == want
    assert all(c[3] == "r1" for c in comps.values())


class _Sink(logging.Handler):
    def __init__(self, name):
        super().__init__()
        self.name_, self.lines = name, []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        logging.getLogger(self.name_).addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger(self.name_).removeHandler(self)


@pytest.mark.parametrize("pinned", [False, True], ids=["routed", "pinned"])
def test_wedge_replays_the_manifest(model, pinned):
    reqs = _reqs(9 if not pinned else 10, 4 if not pinned else 2,
                 max_new=6 if not pinned else 8)
    want = _baseline(model, reqs)
    spans = {}

    def run(pkg):
        fleet, req, chaos = PKG[pkg]
        monkey = chaos.ChaosMonkey(chaos.ChaosPlan.make(
            wedge_replica_at={"r0": 4 if pinned else 3}))
        log = "apex_tpu_torch.inference" if pkg == "port" else "apex_tpu.inference"
        tr = tracing.configure(capacity=8192) if pkg == "port" else None
        with monkey.active(), _Sink(log) as sink:
            fe = _fleet(model, pkg)
            for rid, prompt, new in reqs:
                fe.submit(req(rid, list(prompt), new), **({"replica_id": "r0"} if pinned
                                                          else {}))
            done = fe.run_until_drained()
        assert any("serve.step_wedged" in ln for ln in sink.lines)
        if tr is not None:
            spans["port"] = tr.spans()
            tracing.disable()
        return _view(fe, done)

    comps, stats = _both(model, run)
    assert {rid: c[0] for rid, c in comps.items()} == want
    assert any(c[1] for c in comps.values()) and stats["replica_deaths"] == 1
    replay = [s for s in spans["port"] if s["name"] == "fleet.replay"]
    assert replay
    for rs in replay:
        assert (rs["attrs"]["cause"], rs["attrs"]["from_replica"],
                rs["attrs"]["to_replica"]) == ("wedge", "r0", "r1")
        joined = [s["name"] for s in spans["port"]
                  if s["attrs"].get("trace_id") == rs["attrs"]["trace_id"]]
        assert joined.count("serve.prefill") >= 2 and "serve.request" in joined


def test_brownout_sheds_best_effort_before_rejecting(model):
    def run(pkg):
        fleet, req, _ = PKG[pkg]
        rng = np.random.RandomState(11)
        fe = _fleet(model, pkg, max_batch=1, config=fleet.RouterConfig(
            hedge_after_s=0.0, be_shed_queue_depth=2, reject_queue_depth=4,
            retry_after_s=0.25, affinity_min_tokens=10 ** 6))

        def mk(rid, lane="interactive"):
            return req(rid, rng.randint(0, VOCAB, size=8).tolist(), 4, lane=lane)

        errors = []
        fe.submit(mk(0))
        fe.submit(mk(1))
        with pytest.raises(fleet.Overloaded) as shed:
            fe.submit(mk(100, lane="best_effort"))
        errors.append((shed.value.reason, shed.value.lane, shed.value.retry_after_s))
        fe.submit(mk(2))
        fe.submit(mk(3))
        with pytest.raises(fleet.Overloaded) as rej:
            fe.submit(mk(4))
        errors.append((rej.value.reason, rej.value.lane, rej.value.retry_after_s))
        return _view(fe, fe.run_until_drained()), errors

    (comps, stats), errors = _both(model, run)
    assert errors == [("brownout_shed", "best_effort", 0.25), ("overloaded", "interactive", 0.25)]
    assert sorted(comps) == [0, 1, 2, 3] and stats["rejected"] == 2


def test_drain_then_restart_rejects_nothing(model):
    reqs = _reqs(12, 4, max_new=5)
    want = _baseline(model, reqs)

    def run(pkg):
        fleet, req, _ = PKG[pkg]
        fe = _fleet(model, pkg, max_batch=1, auto_restart=False)
        for i, (rid, prompt, new) in enumerate(reqs):
            fe.submit(req(rid, list(prompt), new), replica_id=f"r{i % 2}")
        fe.step()
        moved = fe.drain_replica("r0")
        r0 = fe.replicas["r0"]
        for _ in range(100):
            if r0.state == "dead":
                break
            fe.step()
        r0.restart()
        r0.step()
        fe.submit(req(50, list(reqs[0][1]), 4), replica_id="r0")
        return _view(fe, fe.run_until_drained()), moved, r0.state

    (comps, stats), moved, state = _both(model, run)
    assert moved == 1 and state == "serving" and stats["rejected"] == 0
    assert {rid: comps[rid][0] for rid in want} == want and 50 in comps


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("n", [2, 3])
def test_one_hedge_for_a_straggler(model, n):
    def run(pkg):
        fleet, req, _ = PKG[pkg]
        rng = np.random.RandomState(13)
        clock = _Clock()
        fe = _fleet(model, pkg, n=n, max_batch=1, time_fn=clock, config=fleet.RouterConfig(
            hedge_after_s=0.5, reject_queue_depth=10 ** 6, be_shed_queue_depth=10 ** 6,
            affinity_min_tokens=10 ** 6))
        fe.submit(req(0, rng.randint(0, VOCAB, size=10).tolist(), 12), replica_id="r0")
        fe.step()
        fe.submit(req(1, rng.randint(0, VOCAB, size=10).tolist(), 4), replica_id="r0")
        clock.t += 1.0
        fe.step()
        clock.t += 1.0
        fe.step()
        return _view(fe, fe.run_until_drained())

    comps, stats = _both(model, run)
    assert stats["hedges"] == 1 and comps[1][2] is True and sorted(comps) == [0, 1]


def test_routing_affinity_least_loaded_and_health_gate(model):
    def run(pkg):
        fleet, req, _ = PKG[pkg]
        rng = np.random.RandomState(15)
        fe = _fleet(model, pkg, prefix_sharing=True, config=fleet.RouterConfig(
            hedge_after_s=0.0, affinity_min_tokens=4, reject_queue_depth=10 ** 6,
            be_shed_queue_depth=10 ** 6))
        prompt = rng.randint(0, VOCAB, size=14).tolist()
        fe.submit(req(0, list(prompt), 4), replica_id="r0")
        fe.run_until_drained()
        reps = list(fe.replicas.values())
        picks = [fe.router.pick(req(1, list(prompt), 4), reps).replica_id,
                 fe.router.pick(req(2, rng.randint(0, VOCAB, size=14).tolist(), 4),
                                reps).replica_id]
        fe.replicas["r0"].kill()
        picks.append(fe.router.pick(req(3, list(prompt), 4), reps).replica_id)
        for r in reps:
            r.kill()
        with pytest.raises(fleet.Overloaded, match="no_serving_replica"):
            fe.router.pick(req(4, list(prompt), 4), reps)
        return picks, [r.prefix_affinity(prompt) for r in reps]

    picks, _ = _both(model, run)
    assert picks == ["r0", "r0", "r1"]


def test_fleet_config_in_the_uniformity_seam(model):
    fe = _fleet(model, "port", page_size=4)
    payload = U.check_uniform(gather=lambda p: [dict(p), dict(p)])
    assert "serve.fleet_config" in payload
    view = fe._uniform_view()
    jfe = _fleet(model, "jax", page_size=4)
    assert sorted(view) == sorted(jfe._uniform_view())
    divergent = tfleet.LocalReplica("r1", lambda: _sched(model, "port", page_size=8)).start()
    other = {**view, "config_digests": {**view["config_digests"], "r1": divergent.config_digest}}
    assert other != view

    def gather(p):
        return [dict(p), {**p, "serve.fleet_config": U.uniform_digest(other)}]

    with pytest.raises(U.UniformityError) as err:
        U.check_uniform(gather=gather)
    assert err.value.tag == "serve.fleet_config"


def test_replica_lifecycle_and_gauges(model):
    with MetricsScope() as reg:
        r = tfleet.LocalReplica("r9", lambda: _sched(model, "port"))
        assert r.state == "dead" and not r.step()
        r.start()
        assert r.state == "warm"
        r.step()
        assert r.state == "serving"
        with pytest.raises(RuntimeError, match="not dead"):
            r.restart()
        r.kill()
        r.restart()
        assert r.restarts == 1 and r.state == "warm"
        g = reg.gauge("apex_fleet_replica_state", labelnames=("replica",))
        assert g.value(replica="r9") == tfleet.REPLICA_STATES.index("warm")
    assert tfleet.REPLICA_STATES == jfleet.REPLICA_STATES
