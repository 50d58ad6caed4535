"""The serving scheduler's hooks (``apex_tpu_torch.inference.scheduler``:
metrics, tracing, the flight recorder, anomaly, the watchdog and chaos
wedge, the drain manifest, ``begin_drain`` and ``cancel``) against the
JAX scheduler's, on the CPU, in fp32.

Both schedulers take one submit trace (the JAX scheduler with its xla
impls and fp32 sampling dots, the port's over the same params carried
by ``params_from_numpy``, as tests/test_torch_serving_v2.py builds
them), each in its own metrics registry and tracer, and step in
lockstep:

- after every step, ``drain_manifest()`` (rid, lane, phase, prompt,
  emitted tokens, remaining budget, in order) and the gauges (queue
  depth, each lane's depth, active slots, free pages) are the JAX
  scheduler's;
- at the end, the completions, the counters (completions, tokens,
  preemptions, copies, verify emissions) and each histogram's sample
  count by lane (admission wait, TTFT, inter-token) are equal, every
  exemplar carries its request's ``trace_id``, and the spans' names and
  counts are the JAX scheduler's (admission waits, prefills or chunks,
  decode or verify steps, requests);
- the port with every hook off gives the same tokens as with them on;
- ``serve_gpt``'s flags of the reference driver: ``--metrics-dir``,
  ``--trace-dir``, ``--replica-id``, ``--run-id`` write the replica's
  metrics and trace and leave the streams as they were; a child with
  ``--watchdog-secs`` and ``--chaos-wedge-decode-step`` exits 75 with a
  manifest of every request, and the same command under ``--supervise``
  (the wedge armed for attempt 0 by its fault script) serves them all;
- ``begin_drain`` and ``cancel`` hand back what JAX's do; a watchdog
  (its ``on_fire`` test seam in place of the exit) fired by an active
  chaos plan's wedged step logs the ``serve.step_wedged`` manifest and
  counts ``apex_serve_wedges_total``, and an anomaly monitor scores
  every TTFT and inter-token sample.

Two traces, each request arriving at a given scheduler step: the plain
decode step with both lanes and a preemption (max batch 2, interactive
requests arriving while best-effort ones hold the slots), and the
verify step (draft 2) with chunked prefill and prefix sharing.  Timing
values are never compared, only counts.
"""

import collections
import json
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.inference import (
    ContinuousBatchingScheduler as JaxScheduler, DecodeConfig as JaxDecodeConfig,
    KVCacheConfig as JaxKVCacheConfig, Request as JaxRequest,
)
from apex_tpu.models import gpt as jgpt
from apex_tpu.observability import metrics as jmetrics
from apex_tpu.observability import tracing as jtracing

from apex_tpu_torch.inference import (
    ContinuousBatchingScheduler, DecodeConfig, KVCacheConfig, ManifestEntry, Request,
)
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.observability import AnomalyMonitor, flightrec
from apex_tpu_torch.observability import metrics as tmetrics
from apex_tpu_torch.observability import tracing as ttracing
from apex_tpu_torch.resilience import ChaosMonkey, ChaosPlan, StepWatchdog

REPO = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=61, hidden_size=32, num_layers=2, num_attention_heads=4,
            max_seq_len=128, position_embedding_type="rope", checkpoint_layers=False)
GAUGES = ("apex_serve_queue_depth", "apex_serve_lane_queue_depth",
          "apex_serve_active_slots", "apex_serve_free_pages")
COUNTERS = ("apex_serve_completions_total", "apex_serve_generated_tokens_total",
            "apex_serve_preemptions_total", "apex_serve_cow_copies_total",
            "apex_serve_spec_emitted_total", "apex_serve_cancelled_total")
HISTOGRAMS = ("apex_serve_admission_wait_seconds", "apex_serve_ttft_seconds",
              "apex_serve_inter_token_seconds")

TRACES = {
    "lanes_preemption": dict(
        dk=dict(max_batch=2),
        requests=[(0, 7, 6, "best_effort", 0), (1, 5, 5, "best_effort", 0),
                  (2, 9, 4, "interactive", 2), (3, 3, 6, "interactive", 2),
                  (4, 6, 3, "best_effort", 3)]),
    "verify_chunked_shared": dict(
        dk=dict(max_batch=3, draft_len=2, prefill_chunk=4, prefix_sharing=True,
                max_prompt=24),
        requests=[(0, 12, 6, "interactive", 0), (1, 14, 5, "interactive", 0),
                  (2, 10, 7, "best_effort", 1), (3, 12, 4, "interactive", 3)],
        system=8),
}


@pytest.fixture(scope="module")
def model():
    base = dict(TINY)
    jcfg = jgpt.GPTConfig(**base, compute_dtype=jnp.float32)
    tcfg = tgpt.GPTConfig(**base, compute_dtype=torch.float32)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _decode_configs(dk):
    dk = dict(dk)
    max_prompt = dk.pop("max_prompt", 16)
    cache = dict(num_pages=40, page_size=4, pages_per_seq=16)
    common = dict(max_prompt_len=max_prompt, temperature=0.0, top_k=0, base_seed=0, **dk)
    jd = JaxDecodeConfig(cache=JaxKVCacheConfig(**cache, dtype=jnp.float32), attn_impl="xla",
                         sample_impl="xla", sample_dot_dtype=jnp.float32, **common)
    td = DecodeConfig(cache=KVCacheConfig(**cache, dtype=torch.float32), **common)
    return jd, td


def _prompts(trace):
    rng = np.random.RandomState(3)
    sysp = rng.randint(0, TINY["vocab_size"], size=trace.get("system", 0)).tolist()
    return [(rid, sysp + rng.randint(0, TINY["vocab_size"], size=n).tolist(), new, lane, at)
            for rid, n, new, lane, at in trace["requests"]]


def _arrive(sched, reqs, req_cls, step):
    """Submit the requests that arrive at scheduler step ``step``."""
    for rid, prompt, new, lane, at in reqs:
        if at == step:
            sched.submit(req_cls(rid, list(prompt), new, lane=lane))


def _serve(sched, reqs, req_cls):
    """Step with the trace's arrivals until drained; the completions."""
    for step in range(500):
        _arrive(sched, reqs, req_cls, step)
        if sched.idle() and step > max(r[-1] for r in reqs):
            return sched.completed
        sched.step()
    raise AssertionError("not drained")


def _samples(reg, names):
    out = {}
    for m in reg.metrics():
        for name, labels, value in m.samples():
            base = name[:-len("_count")] if name.endswith("_count") else name
            if name in names or (name.endswith("_count") and base in names):
                out[(name, tuple(sorted(labels.items())))] = value
    return out


def _manifest(sched):
    return [(m.rid, m.lane, m.phase, list(m.prompt), list(m.emitted), m.remaining)
            for m in sched.drain_manifest()]


def _lockstep(model, trace):
    """Both schedulers over one trace, hooks on; returns what each saw."""
    jcfg, jp, tcfg, tp = model
    jd, td = _decode_configs(trace["dk"])
    reqs = _prompts(trace)
    side = {}
    for name, scope_m, scope_t, make in (
            ("jax", jmetrics.MetricsScope, jtracing.TracingScope,
             lambda: JaxScheduler(jp, jcfg, jd)),
            ("port", tmetrics.MetricsScope, ttracing.TracingScope,
             lambda: ContinuousBatchingScheduler(tp, tcfg, td, device="cpu",
                                                 metrics=True))):
        side[name] = {"m": scope_m(), "t": scope_t()}
        with side[name]["m"] as reg, side[name]["t"]:
            sched = make()
        side[name].update(sched=sched, reg=reg, steps=[],
                          req=JaxRequest if name == "jax" else Request)
    last = max(r[-1] for r in reqs)
    for step in range(200):
        done = []
        for name in ("jax", "port"):
            s = side[name]
            with s["m"], s["t"]:
                _arrive(s["sched"], reqs, s["req"], step)
                if not s["sched"].idle():
                    s["sched"].step()
                s["steps"].append((_manifest(s["sched"]), _samples(s["reg"], GAUGES)))
                done.append(s["sched"].idle() and step >= last)
        if all(done):
            break
    return side


@pytest.mark.parametrize("name", sorted(TRACES))
def test_hooks_record_what_the_jax_scheduler_records(model, name):
    side = _lockstep(model, TRACES[name])
    j, t = side["jax"], side["port"]
    assert len(t["steps"]) == len(j["steps"])
    for i, (got, want) in enumerate(zip(t["steps"], j["steps"])):
        assert got[0] == want[0], f"manifest after step {i}"
        assert got[1] == want[1], f"gauges after step {i}"
    assert t["steps"][-1][0] == []  # drained: nothing unfinished
    assert {c.rid: c.tokens for c in t["sched"].completed} == \
        {c.rid: c.tokens for c in j["sched"].completed}
    assert _samples(t["reg"], COUNTERS) == _samples(j["reg"], COUNTERS)
    assert _samples(t["reg"], HISTOGRAMS) == _samples(j["reg"], HISTOGRAMS)
    if name == "lanes_preemption":
        assert t["sched"].stats["preemptions"] > 0
    else:
        assert t["sched"].stats["spec_steps"] > 0 and t["sched"].stats["chunk_steps"] > 0
    names = {k: collections.Counter(s["name"] for s in side[k]["t"].tracer.spans())
             for k in ("jax", "port")}
    assert names["port"] == names["jax"]
    assert names["port"]["serve.request"] == len(TRACES[name]["requests"])
    # every exemplar names its request's trace id
    ids = {c.rid: c.trace_id for c in t["sched"].completed}
    assert all(ids.values())
    hist = t["reg"].histogram("apex_serve_ttft_seconds", labelnames=("lane",))
    ex = hist.drain_exemplars()
    assert ex and all(e["trace_id"] == ids[e["rid"]] for _, e in ex)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_streams_with_hooks_off_equal_hooks_on(model, name, tmp_path):
    """Hooks off (no metrics, no tracer, no monitor) against all on
    (metrics, a tracer with a flight recorder attached, an anomaly
    monitor): the same tokens, nothing recorded with metrics off, and
    the recorder's ring holds the serving spans."""
    jcfg, jp, tcfg, tp = model
    _, td = _decode_configs(TRACES[name]["dk"])
    reqs = _prompts(TRACES[name])

    def run(hooks):
        sched = ContinuousBatchingScheduler(
            tp, tcfg, td, device="cpu", anomaly=AnomalyMonitor() if hooks else None,
            metrics=hooks)
        return {c.rid: c.tokens for c in _serve(sched, reqs, Request)}

    with tmetrics.MetricsScope() as quiet:
        off = run(False)
    assert not [n for m in quiet.metrics() for n, _, _ in m.samples()
                if n.startswith("apex_serve_")]  # metrics off: nothing recorded
    rec = flightrec.FlightRecorder(tmp_path)
    with tmetrics.MetricsScope(), ttracing.TracingScope() as tracer:
        rec.attach(tracer)
        on = run(True)
    assert on == off
    kinds = {s["name"] for s in rec.snapshot()["spans"]}
    assert {"serve.request", "serve.admission_wait"} <= kinds


def test_begin_drain_and_cancel_match_jax(model):
    jcfg, jp, tcfg, tp = model
    jd, td = _decode_configs(dict(max_batch=2))
    reqs = _prompts(TRACES["lanes_preemption"])
    out = {}
    for name, make, req in (("jax", lambda: JaxScheduler(jp, jcfg, jd), JaxRequest),
                            ("port", lambda: ContinuousBatchingScheduler(tp, tcfg, td,
                                                                         device="cpu"),
                             Request)):
        with (jmetrics if name == "jax" else tmetrics).MetricsScope():
            s = make()
            for rid, prompt, new, lane, _ in reqs:
                s.submit(req(rid, list(prompt), new, lane=lane))
            cancelled = s.cancel(4)
            s.step()
            s.step()
            manifest = s.begin_drain()
            with pytest.raises(RuntimeError, match="draining"):
                s.submit(req(9, [1, 2], 2))
            before = s.drained()
            done = s.run_until_drained()
            out[name] = (cancelled.rid, s.cancel(99),
                         [(m.rid, m.lane, m.phase, m.emitted, m.remaining) for m in manifest],
                         before, s.drained(), sorted(c.rid for c in done))
    assert out["port"] == out["jax"]
    assert out["port"][2] and out["port"][4] is True


def test_chaos_wedge_fires_the_watchdog_with_the_manifest(model):
    """An active plan wedges the step after decode step 1; the watchdog
    (``on_fire`` in place of the exit) fires inside the sleep, and the
    scheduler's hook logs every queued and in-flight request with its
    emitted tokens, and counts the wedge."""
    jcfg, jp, tcfg, tp = model
    _, td = _decode_configs(dict(max_batch=2))
    fired, records = [], []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logger = logging.getLogger("apex_tpu_torch.inference")
    keep = Keep()
    logger.addHandler(keep)
    wd = StepWatchdog(0.2, first_deadline_sec=5.0, poll_sec=0.02, on_fire=fired.append)
    with tmetrics.MetricsScope() as reg:
        sched = ContinuousBatchingScheduler(tp, tcfg, td, device="cpu", watchdog=wd)
        for rid, prompt, new, lane, _ in _prompts(TRACES["lanes_preemption"]):
            sched.submit(Request(rid, list(prompt), new, lane=lane))
        monkey = ChaosMonkey(ChaosPlan.make(wedge_step_at=1, wedge_step_seconds=0.6))
        wd.start()
        try:
            with monkey.active():
                for _ in range(3):
                    sched.step()
                    if fired:
                        break
        finally:
            wd.stop()
            logger.removeHandler(keep)
        wedges = reg.counter("apex_serve_wedges_total").value()
    assert fired and monkey.injected == {"wedge_step": 1}
    assert wedges == 1
    msg = next(m for m in records if "serve.step_wedged" in m)
    for rid in range(5):
        assert f'"rid": {rid}' in msg
    assert '"phase": "in_flight"' in msg and '"phase": "queued"' in msg
    assert isinstance(sched.drain_manifest()[0], ManifestEntry)


def test_anomaly_scores_every_latency_sample(model):
    """The monitor sees each TTFT and inter-token sample, by lane, as the
    JAX scheduler's monitor does on the same trace (a preemption's next
    leg scores a TTFT of its own)."""
    jcfg, jp, tcfg, tp = model
    jd, td = _decode_configs(dict(max_batch=2))

    class Recorder:
        def __init__(self):
            self.seen = collections.Counter()

        def observe(self, kind, value, **labels):
            self.seen[(kind, labels["lane"])] += 1

    reqs = _prompts(TRACES["lanes_preemption"])
    seen = {}
    for name, make, req, scope in (
            ("jax", lambda m: JaxScheduler(jp, jcfg, jd, anomaly=m), JaxRequest, jmetrics),
            ("port", lambda m: ContinuousBatchingScheduler(tp, tcfg, td, device="cpu",
                                                           anomaly=m), Request, tmetrics)):
        mon = Recorder()
        with scope.MetricsScope():
            done = _serve(make(mon), reqs, req)
        seen[name] = mon.seen
    assert seen["port"] == seen["jax"]
    n_tok = sum(len(c.tokens) for c in done)
    assert sum(seen["port"].values()) >= n_tok and seen["port"][("ttft", "interactive")] == 2


# ------------------------------------------------------ serve_gpt flags
SERVE = ["--device", "cpu", "--layers", "2", "--hidden", "32", "--heads", "4", "--vocab", "61",
         "--requests", "6", "--streams", "2", "--prompt-len", "8", "--max-new", "4",
         "--page-size", "4", "--compute-dtype", "float32", "--kv-dtype", "float32",
         "--temperature", "0"]


def test_serve_gpt_observability_flags(tmp_path):
    """``--metrics-dir --trace-dir --replica-id --run-id``: the replica's
    metrics files, the trace and the per-lane anomaly counts; the streams
    those of the same command without them."""
    from apex_tpu_torch import serve_gpt

    def run(extra):
        args = serve_gpt.build_args().parse_args(SERVE + extra)
        with tmetrics.MetricsScope():
            out, sched, _, _ = serve_gpt.run(args)
        return out, {c.rid: c.tokens for c in sched.completed}

    out, on = run(["--metrics-dir", str(tmp_path / "m"), "--trace-dir", str(tmp_path / "t"),
                   "--replica-id", "r1", "--run-id", "svc"])
    _, off = run([])
    assert on == off and out["requests"] == 6
    assert (tmp_path / "m" / "metrics_r1.jsonl").exists()
    prom = (tmp_path / "m" / "metrics_r1.prom").read_text()
    assert "apex_serve_ttft_seconds_count" in prom and "apex_serve_free_pages" in prom
    trace = out["trace_file"]
    assert "svc_r1" in trace and Path(trace).exists()
    assert out["anomaly"] == {"counts": {}, "by_lane": {}} or "counts" in out["anomaly"]
    assert ttracing.get_tracer() is None and flightrec.active() is None  # torn down


def _serve_proc(extra, timeout=240):
    return subprocess.run([sys.executable, "-m", "apex_tpu_torch.serve_gpt", *SERVE, *extra],
                          cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_serve_gpt_wedge_exits_75_then_supervised_serves_all(tmp_path):
    """A wedged decode step (``--chaos-wedge-decode-step`` past
    ``--watchdog-secs``) exits 75 with a manifest naming every queued and
    in-flight request; the same command under ``--supervise``, the wedge
    armed for attempt 0 only by its fault script, restarts once and serves
    every request."""
    # a 5 s deadline: a plain step of this tiny model on a loaded CPU must
    # not pass for a wedge (a 1 s deadline did, under a parallel test run)
    wedge = ["--watchdog-secs", "5", "--chaos-wedge-decode-step", "2",
             "--chaos-wedge-secs", "60"]
    res = _serve_proc(wedge)
    assert res.returncode == 75, res.stderr[-2000:]
    line = next(ln for ln in res.stderr.splitlines() if "serve.step_wedged" in ln)
    rec = json.loads(line.split("serve.step_wedged ", 1)[1])
    assert sorted(rec["queued_rids"] + rec["inflight_rids"]) == list(range(6))
    assert rec["inflight"] == 2 and {m["rid"] for m in rec["manifest"]} == set(range(6))
    script = tmp_path / "faults.json"
    script.write_text(json.dumps({"0": {"args": wedge[2:]}}))
    res = _serve_proc(["--watchdog-secs", "5", "--supervise", "--fault-script", str(script),
                       "--backoff-base", "0.05"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stderr.count("supervisor.restarting") == 1
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["requests"] == 6 and report["generated_tokens"] == 24
