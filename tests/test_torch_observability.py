"""The port's observability and resilience host modules against the JAX
package's, on the CPU.

- metrics: the same records give a byte-equal Prometheus exposition and
  equal JSONL samples; ``StepTelemetry.emit`` of one harvested window
  gives ``prometheus_text()`` byte-equal to the JAX package's;
- goodput: ``goodput_report`` equals the reference's on the same session
  files, whichever side wrote them;
- tracing: the Chrome/Perfetto export and the spans JSONL carry the
  reference's event fields;
- the flight recorder's dumps load on either side; the anomaly
  detectors alert on the same samples; the correlation context is the
  same;
- stepstats: ``accumulate`` against the JAX package's on the same
  values, the capture seam, the CPU fetcher's FIFO harvest;
- the step guard counts its abort and dumps the flight recorder before
  it raises;
- the watchdog fires ``on_fire`` on a step that sleeps past its
  deadline; the preemption handler's ``simulate`` and drain.
"""

import json
import math
import time

import numpy as np
import pytest
import torch

from apex_tpu.observability import anomaly as janomaly
from apex_tpu.observability import correlation as jcorr
from apex_tpu.observability import flightrec as jflight
from apex_tpu.observability import goodput as jgoodput
from apex_tpu.observability import metrics as jmetrics
from apex_tpu.observability import stepstats as jstats
from apex_tpu.observability import tracing as jtracing

from apex_tpu_torch.observability import (
    anomaly, correlation, flightrec, goodput, metrics, stepstats, tracing,
)
from apex_tpu_torch.resilience import (
    BadStepBudgetExceeded, PreemptionHandler, StepGuard, StepWatchdog,
)


def _record(m, reg):
    """The same records into a registry of either side."""
    c = reg.counter("apex_t_total", 'a "quoted" help\nline', ("lane", "k"))
    c.inc(lane="a", k='x"y')
    c.inc(2.5, lane="b", k="z")
    reg.gauge("apex_t_gauge").set(3.0)
    reg.gauge("apex_t_big").set(1e17)
    h = reg.histogram("apex_t_seconds", "lat", ("lane",), buckets=(0.001, 0.1, 1.0))
    for v in (0.0005, 0.05, 0.5, 5.0):
        h.observe(v, lane="x")
    with m.MetricsScope(reg):
        m.inc("apex_helper_total", 3, op="read")
        m.set_gauge("apex_helper_gauge", 0.25)
        m.observe("apex_helper_seconds", 0.2)


def test_prometheus_text_and_jsonl_match_reference(tmp_path):
    ours, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _record(metrics, ours)
    _record(jmetrics, theirs)
    assert ours.prometheus_text() == theirs.prometheus_text()
    correlation.set_step_context(run_id="r x", step=7)
    jcorr.set_step_context(run_id="r x", step=7)
    try:
        n1 = ours.snapshot_jsonl(tmp_path / "a.jsonl", window_end_step=7)
        n2 = theirs.snapshot_jsonl(tmp_path / "b.jsonl", window_end_step=7)
    finally:
        correlation.clear_step_context()
        jcorr.clear_step_context()
    assert n1 == n2

    def lines(p):
        out = [json.loads(x) for x in p.read_text().splitlines()]
        for rec in out:
            rec.pop("ts")
        return out

    assert lines(tmp_path / "a.jsonl") == lines(tmp_path / "b.jsonl")


_WINDOWS = {
    "plain": dict(steps=4, loss_sum=24.5, loss_last=6.0, grad_norm_sum=3.5, grad_norm_last=0.8,
                  notfinite=0, loss_scale=float("nan"), param_norm=12.5, update_norm=0.01),
    "amp_overflow": dict(steps=4, loss_sum=float("inf"), loss_last=5.5, grad_norm_sum=2.0,
                         grad_norm_last=0.5, notfinite=1, loss_scale=2048.0, param_norm=9.0,
                         update_norm=0.02),
    "no_grad_norm": dict(steps=2, loss_sum=13.0, loss_last=6.4, grad_norm_sum=0.0,
                         grad_norm_last=float("nan"), notfinite=0, loss_scale=float("nan"),
                         param_norm=float("nan"), update_norm=float("nan")),
}


@pytest.mark.parametrize("window", sorted(_WINDOWS))
def test_emit_of_a_harvested_window_matches_reference(window):
    w = _WINDOWS[window]
    tree = {k: (np.int32(v) if k in ("steps", "notfinite") else np.float32(v))
            for k, v in w.items()}
    ours, theirs = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    s1 = stepstats.StepTelemetry.emit(ours, tree)
    s1b = stepstats.StepTelemetry.emit(ours, tree)  # a second window adds up
    s2 = jstats.StepTelemetry.emit(theirs, tree)
    jstats.StepTelemetry.emit(theirs, tree)
    assert json.dumps(s1, sort_keys=True) == json.dumps(s2, sort_keys=True) == json.dumps(
        s1b, sort_keys=True)
    assert ours.prometheus_text() == theirs.prometheus_text()


def _clock():
    t = {"now": 1000.0}

    def fn():
        return t["now"]

    fn.advance = lambda dt: t.__setitem__("now", t["now"] + dt)
    return fn


def _sessions(mod, d, clk, wedge):
    a1 = mod.GoodputAccountant(d, run_id="r", time_fn=clk)
    clk.advance(10)
    a1.step_done(steps=10, tokens=1000)
    with a1.attribute("checkpoint"):
        clk.advance(2)
    clk.advance(4)
    if wedge:
        a1.finalize("wedge")
    else:
        a1.heartbeat()  # hard-killed after its last heartbeat
    clk.advance(6)
    a2 = mod.GoodputAccountant(d, run_id="r", time_fn=clk)
    with a2.attribute("restore"):
        clk.advance(1)
    clk.advance(8)
    a2.step_done(steps=8, tokens=800)
    a2.finalize("clean")


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("wedge", [True, False], ids=["wedge", "killed"])
def test_goodput_report_matches_reference(tmp_path, writer, wedge):
    _sessions(goodput if writer == "port" else jgoodput, tmp_path, _clock(), wedge)
    kw = dict(flops_per_token=goodput.model_flops_per_token(1000, 2, 16, 32),
              roofline_tflops=1e-9)
    ours, theirs = goodput.goodput_report(tmp_path, **kw), jgoodput.goodput_report(tmp_path, **kw)
    assert ours == theirs
    assert ours["sessions"] == 2 and abs(sum(ours["fractions"].values()) - 1.0) < 1e-9
    assert goodput.session_progress(tmp_path) == jgoodput.session_progress(tmp_path) == 18
    (tmp_path / "goodput_report.json").write_text(json.dumps(ours))
    assert goodput.goodput_report(tmp_path) == jgoodput.goodput_report(tmp_path)
    assert goodput.param_count({"a": torch.zeros(3, 4), "b": [torch.zeros(5), None]}) == 17


def _spans(tr, mod):
    with tr.span("train.data_wait"):
        pass
    step = mod.TracedStep(lambda x: x + 1, name="train.step.dispatch")
    assert step(1) == 2
    tr.instant("marker", k=1)
    tr.emit("train.checkpoint_restore", time.time(), 0.25, resumed_step=4)
    try:
        with tr.span("train.checkpoint_save", save_step=4):
            raise KeyError("x")
    except KeyError:
        pass
    tr.span("open.one")  # never finished: exported flagged open


def test_trace_export_has_the_reference_fields(tmp_path):
    correlation.set_step_context(run_id="gpt", step=3)
    jcorr.set_step_context(run_id="gpt", step=3)
    try:
        with tracing.TracingScope() as ours:
            _spans(ours, tracing)
            assert tracing.enabled()
            exp = tracing.export_run(tmp_path / "p", "gpt")
        with jtracing.TracingScope() as theirs:
            _spans(theirs, jtracing)
            jexp = jtracing.export_run(tmp_path / "j", "gpt")
    finally:
        correlation.clear_step_context()
        jcorr.clear_step_context()
    assert not tracing.enabled()
    assert exp["events"] == jexp["events"] and exp["dropped"] == jexp["dropped"] == 0
    assert exp["chrome"].endswith(f"trace_gpt_{__import__('os').getpid()}.json")
    a, b = (json.loads(open(e["chrome"]).read()) for e in (exp, jexp))
    assert a.keys() == b.keys() and a["schema"] == b["schema"]
    assert a["otherData"] == b["otherData"] and a["displayTimeUnit"] == b["displayTimeUnit"]

    def shape(events):
        return sorted((e["name"], e["ph"], tuple(sorted(e)), tuple(sorted(e["args"])))
                      for e in events)

    assert shape(a["traceEvents"]) == shape(b["traceEvents"])
    names = [e["name"] for e in a["traceEvents"]]
    assert {"train.data_wait", "train.step.dispatch", "train.checkpoint_save",
            "train.checkpoint_restore", "thread_name"} <= set(names)

    def jsonl(p):
        return sorted((r["span"], tuple(sorted(r))) for r in
                      (json.loads(x) for x in open(p).read().splitlines()))

    assert jsonl(exp["jsonl"]) == jsonl(jexp["jsonl"])
    assert tracing.emit_sync_plan(object()) == {"markers": 0, "overlap_fraction": 0.0}
    assert correlation.span_suffix() == jcorr.span_suffix() == ""


def test_tracer_ring_drops_oldest_like_the_reference():
    for mod in (tracing, jtracing):
        tr = mod.Tracer(capacity=3)
        for i in range(5):
            with tr.span(f"s{i}"):
                pass
        assert [s["name"] for s in tr.spans()] == ["s2", "s3", "s4"] and tr.dropped == 2


def test_flight_recorder_dumps_load_on_either_side(tmp_path):
    rec = flightrec.install(flightrec.FlightRecorder(tmp_path, run_id="gpt"))
    try:
        with tracing.TracingScope() as tr:
            rec.attach(tr)
            with tr.span("train.step.dispatch"):
                pass
            rec.record_stats(4, {"loss_mean": 1.5})
            from apex_tpu_torch.utils.logging import get_logger, log_structured

            log_structured(get_logger("t"), 30, "test.event", value=3)
            assert rec.checkpoint() is not None
            path = flightrec.dump_active("wedge", wedged_step=4)
    finally:
        flightrec.uninstall()
    assert flightrec.dump_active("wedge") is None  # no recorder: no-op
    for load in (flightrec.load_dump, jflight.load_dump):
        d = load(path)
        assert d["reason"] == "wedge" and d["run_id"] == "gpt" and d["wedged_step"] == 4
        assert [s["name"] for s in d["spans"]] == ["train.step.dispatch"]
        assert d["stats_windows"][0]["step"] == 4
        assert any(e["event"] == "test.event" and e["value"] == 3 for e in d["events"])
    (tmp_path / "flightrec_dump_99999999999999_1.json").write_text("{torn")
    hit = flightrec.latest_dump(tmp_path)
    assert hit is not None and hit[0] != str(tmp_path / "flightrec_dump_99999999999999_1.json")
    assert flightrec.default_dir(metrics_dir="m") == jflight.default_dir(metrics_dir="m")


def test_anomaly_detectors_alert_like_the_reference(tmp_path):
    rng = np.random.RandomState(0)
    series = list(1.0 + 0.01 * rng.randn(40)) + [3.0, 1.0, 0.2]
    for direction in ("high", "low", "both"):
        ours = anomaly.RollingMadDetector(window=16, min_points=8, direction=direction)
        theirs = janomaly.RollingMadDetector(window=16, min_points=8, direction=direction)
        assert [ours.update(v) for v in series] == [theirs.update(v) for v in series]
    mon = anomaly.AnomalyMonitor(min_points=8)
    with metrics.MetricsScope() as reg:
        for v in series:
            mon.observe("step_time", v)
        mon.wedge(12.0, step=5)
        assert reg.counter("apex_anomaly_step_time_total").value() == mon.counts()["step_time"]
    assert mon.persist(tmp_path) is not None
    assert janomaly.recent_alert_count(tmp_path) == anomaly.recent_alert_count(tmp_path) >= 2


# ---------------------------------------------------------------- stepstats
def test_accumulate_matches_reference():
    tel, jtel = stepstats.StepTelemetry(), jstats.StepTelemetry()
    rng = np.random.RandomState(1)
    old = {"a": rng.randn(5, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    new = {k: v + 0.01 * rng.randn(*v.shape).astype(np.float32) for k, v in old.items()}
    s, js = tel.init("cpu"), jtel.init()
    for i, (finite, gn) in enumerate(((True, 0.5), (False, None), (True, 0.25))):
        kw = dict(loss=np.float32(2.0 + i), finite=finite, loss_scale=np.float32(512.0 / (i + 1)))
        s = tel.accumulate(
            s, **{k: torch.as_tensor(v) for k, v in kw.items()},
            grad_norm=None if gn is None else torch.tensor(gn),
            new_params={k: torch.from_numpy(v) for k, v in new.items()},
            old_params={k: torch.from_numpy(v) for k, v in old.items()})
        js = jtel.accumulate(js, **kw, grad_norm=gn, new_params=new, old_params=old)
    for name in stepstats.StepStats._fields:
        got, want = getattr(s, name).numpy(), np.asarray(getattr(js, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    off = stepstats.StepTelemetry(norms=False).accumulate(
        tel.init("cpu"), loss=torch.tensor(1.0), new_params=new, old_params=old)
    assert math.isnan(float(off.param_norm)) and int(off.notfinite) == 0


def test_window_accumulates_in_place_and_resets():
    tel = stepstats.StepTelemetry(norms=False)
    s = tel.init("cpu")
    ptrs = [t.data_ptr() for t in s]
    for i in range(3):
        tel.accumulate_(s, loss=torch.tensor(float(i)), grad_norm=torch.tensor(1.0),
                        finite=torch.tensor(i != 1))
    assert [t.data_ptr() for t in s] == ptrs
    assert (int(s.steps), float(s.loss_sum), int(s.notfinite)) == (3, 3.0, 1)
    tel.reset(s)
    fresh = tel.init("cpu")
    assert all(torch.equal(a, b) or (a.isnan() & b.isnan()).all() for a, b in zip(s, fresh))
    assert [t.data_ptr() for t in s] == ptrs


def test_capture_seam_and_cpu_fetcher():
    assert not stepstats.capturing()
    stepstats.offer("grad_norm", 1.0)  # no capture: no-op
    with stepstats.capture() as cap:
        assert stepstats.capturing()
        stepstats.offer_local_grad_norm([torch.full((3,), 2.0), torch.full((4,), 1.0)])
    assert float(cap["grad_norm"]) == pytest.approx(4.0)
    f = stepstats.AsyncFetcher()
    t = torch.tensor(1.5)
    f.put("loss", 0, {"loss": t})
    t.add_(1.0)  # the fetch copied it
    f.put("stats", 1, stepstats.StepTelemetry().init("cpu"))
    out = f.ready()
    assert [(k, s) for k, s, _ in out] == [("loss", 0), ("stats", 1)]
    assert float(out[0][2]["loss"]) == 1.5 and int(out[1][2]["steps"]) == 0
    f.put("loss", 2, {"loss": t, "n": 3})
    assert len(f) == 1 and f.flush()[0][2]["n"] == 3 and len(f) == 0


# -------------------------------------------------------------- resilience
def test_step_guard_abort_counts_and_dumps(tmp_path):
    guard = StepGuard(max_consecutive_bad=2)
    state = guard.init("cpu")
    for _ in range(2):
        state = guard.update(state, torch.tensor(False))
    rec = flightrec.install(flightrec.FlightRecorder(tmp_path, run_id="g"))
    try:
        with metrics.MetricsScope() as reg:
            with pytest.raises(BadStepBudgetExceeded, match="2 consecutive"):
                guard.check(state)
            assert reg.counter("apex_bad_step_budget_aborts_total").value() == 1.0
    finally:
        flightrec.uninstall()
    assert len(rec.dumped) == 1
    d = flightrec.load_dump(rec.dumped[0])
    assert d["reason"] == "step_guard_abort"
    assert (d["consecutive_bad"], d["total_skipped"], d["guard_step"]) == (2, 2, 2)


def test_watchdog_fires_on_a_step_that_sleeps():
    fired = []
    wedged = []

    class Ckpt:
        def wait_until_finished(self):
            pass

    with metrics.MetricsScope() as reg:
        wd = StepWatchdog(0.2, checkpointer=Ckpt(), poll_sec=0.02, first_deadline_sec=5.0,
                          on_fire=fired.append, on_wedge=wedged.append)
        with wd:
            for i in range(3):  # healthy steps beat in time
                wd.beat(i)
                time.sleep(0.02)
            assert not wd.fired
            wd.beat(3)
            deadline = time.monotonic() + 5.0
            while not wd.fired and time.monotonic() < deadline:
                time.sleep(0.05)  # the stub step that never returns in time
        assert reg.counter("apex_watchdog_wedges_total").value() == 1.0
    assert wd.fired and len(fired) == 1 and wedged == [fired[0]]
    assert fired[0]["step"] == 3 and fired[0]["drain"] == "drained"
    assert fired[0]["exit_code"] == 75


def test_preemption_simulate_and_drain():
    class Ckpt:
        calls = 0

        def wait_until_finished(self):
            Ckpt.calls += 1

    with metrics.MetricsScope() as reg:
        with PreemptionHandler() as pre:
            assert not pre.preempted
            pre.simulate("drill")
            assert pre.preempted and pre.reason == "drill"
            pre.drain(Ckpt())
        assert Ckpt.calls == 1
        assert reg.counter("apex_preemptions_total").value() == 1.0
        assert reg.counter("apex_preemption_drains_total").value() == 1.0
    pre = PreemptionHandler(deadline_sec=0.0, grace_sec=0.0)
    assert pre.preempted and pre.reason == "deadline approaching"
