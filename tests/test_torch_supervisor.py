"""The port's supervisor (``apex_tpu_torch.resilience.supervisor``)
against the JAX package's, on the CPU.

- The restart state machine, decision for decision: both packages'
  ``Supervisor`` run the same scripted children (a fake ``spawn_fn``
  whose children exit with the scripted codes), the same seed (the
  default per-(seed, attempt) jitter, no ``rng`` pin), the same progress
  and anomaly readings and the same ``SupervisorFaultScript``; the final
  exit code, the restarts, every backoff, the spawned argv, the
  SIGTERM forwarding and the quarantined checkpoints must be equal —
  clean exit, 75 / 137 / unknown codes, the breaker (exit 76), the cap,
  progress resetting the streak, the restart budget, a wedge repeating
  at one progress point, fresh anomaly alerts, SIGTERM during a child
  and during a backoff, per-attempt fault args and a corrupted newest
  checkpoint quarantined on real files.
- ``strip_supervisor_argv`` and ``restart_backoff`` equal to JAX's.
- One real child round trip: ``python -m apex_tpu_torch.pretrain_gpt
  --device cpu --zero --auto-resume --save-every 1 --supervise`` at a
  tiny width, its fault script killing attempt 0 at step 1
  (``--chaos-kill-at-step``, exit 137): rc 0, one restart, and the
  resumed child's losses, its final one included, bitwise equal to an
  unkilled run's at the same steps (the trainer resumes bitwise).

All exact: decisions are integers and strings, and the backoffs come
from the same seeded stream.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from apex_tpu.resilience import chaos as jchaos
from apex_tpu.resilience import elastic as jelastic
from apex_tpu.resilience import supervisor as jsup

from apex_tpu_torch.io import checkpoint as tckpt
from apex_tpu_torch.resilience import chaos as tchaos
from apex_tpu_torch.resilience import elastic as telastic
from apex_tpu_torch.resilience import supervisor as tsup

REPO = Path(__file__).resolve().parent.parent
PKGS = {"port": (tsup, tchaos), "jax": (jsup, jchaos)}


class FakeChild:
    def __init__(self, rc):
        self.rc = rc
        self.terminated = self.killed = 0

    def wait(self, timeout=None):
        return self.rc

    def terminate(self):
        self.terminated += 1

    def kill(self):
        self.killed += 1


def _drive(pkg, codes, *, progress=None, anomaly=None, script=None, stop_at=None,
           stop_in_backoff=False, ckdir=None, real_progress=False, **kw):
    """Run one package's Supervisor over scripted children; returns its
    decisions."""
    sup_mod, chaos_mod = PKGS[pkg]
    it = iter(codes)
    spawned, sleeps, holder = [], [], {}

    def spawn(argv):
        child = FakeChild(next(it))
        spawned.append((list(argv), child))
        if stop_at is not None and len(spawned) == stop_at:
            holder["sup"].request_stop()  # SIGTERM racing this child
        return child

    def sleep(s):
        sleeps.append(s)
        if stop_in_backoff:
            holder["sup"].request_stop()

    fault = (chaos_mod.SupervisorFaultScript.from_dict(script) if script is not None else None)
    kw = {"seed": 7, "backoff_base": 1.0, "backoff_cap": 8.0, **kw}
    sup = sup_mod.Supervisor(
        ["trainer", "--flag"], spawn_fn=spawn, sleep_fn=sleep, time_fn=lambda: 0.0,
        fault_script=fault,
        checkpoint_dir=ckdir,
        progress_fn=(None if real_progress else
                     progress() if progress is not None else (lambda: 0)),
        anomaly_fn=anomaly() if anomaly is not None else (lambda: 0), **kw)
    holder["sup"] = sup
    rc = sup.run()
    return {"rc": rc, "restarts": sup.restarts, "attempt": sup.attempt,
            "backoffs": list(sup.backoffs), "sleeps": sleeps,
            "argv": [a for a, _ in spawned],
            "signals": [(c.terminated, c.killed) for _, c in spawned],
            "quarantined": [Path(q).name for q in sup.quarantined]}


def _rising():
    state = {"p": 0}

    def progress():
        state["p"] += 1
        return state["p"]
    return progress


def _alerts(seq):
    def make():
        it = iter(seq)
        last = [0]

        def read():
            last[0] = next(it, last[0])
            return last[0]
        return read
    return make


SCENARIOS = {
    "clean": dict(codes=[0]),
    "wedged_then_clean": dict(codes=[telastic.EXIT_WEDGED, 0]),
    "killed_then_clean": dict(codes=[telastic.EXIT_KILLED, 0]),
    "unknown_code_restarts": dict(codes=[3, 0]),
    "breaker": dict(codes=[1, 1, 1], crash_loop_threshold=3),
    "cap": dict(codes=[1] * 6, crash_loop_threshold=6, backoff_cap=4.0),
    "progress_resets_streak": dict(codes=[telastic.EXIT_KILLED] * 5 + [0],
                                   progress=_rising, crash_loop_threshold=2),
    "restart_budget": dict(codes=[9, 9], max_restarts=1, crash_loop_threshold=99),
    "wedge_repeats_lengthen": dict(codes=[75, 75, 75, 0], crash_loop_threshold=10),
    "wedge_at_new_progress": dict(codes=[75, 75, 0], progress=_rising),
    "anomaly_doubles": dict(codes=[1, 1, 0], anomaly=_alerts([0, 2, 2, 5]),
                            crash_loop_threshold=5),
    "sigterm_during_child": dict(codes=[143], stop_at=1),
    "sigterm_in_backoff": dict(codes=[1, 0], stop_in_backoff=True),
    "fault_script_args": dict(codes=[137, 75, 0], progress=_rising,
                              script={"0": {"args": ["--chaos-kill-at-step", "3"]},
                                      "1": {"args": ["--chaos-wedge-step", "4"]}}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decisions_equal_the_jax_supervisor(name):
    got, want = (_drive(pkg, **SCENARIOS[name]) for pkg in ("port", "jax"))
    assert got == want
    if name == "breaker":
        assert got["rc"] == tsup.EXIT_CRASH_LOOP == 76 and got["restarts"] == 2
    if name == "killed_then_clean":
        assert got["rc"] == 0 and got["restarts"] == 1 and len(got["backoffs"]) == 1
    if name == "sigterm_during_child":
        assert got["rc"] == 143 and got["signals"] == [(1, 0)]


def _ckpt_dir(d):
    d.mkdir()
    for s in (1, 2):
        tckpt.save_checkpoint(d / f"step_{s:08d}.ckpt", {"w": torch.full((256,), float(s))})
    return d


def _step_dirs(d, complete):
    """``step_00000001/`` (complete) and ``step_00000002/`` (its rank-1
    shard never written, or complete when ``complete``), world 2: the
    elastic layout a hard kill interrupts."""
    d.mkdir()
    for step in (1, 2):
        for rank in (0, 1):
            if step == 2 and rank == 1 and not complete:
                continue
            tckpt.save_sharded_checkpoint(d / f"step_{step:08d}",
                                          {"w": torch.full((64,), float(step))}, rank, 2)
    return d


@pytest.mark.parametrize("how", ["corrupted_before", "fault_script", "incomplete_publish",
                                 "incomplete_newest_with_complete_sibling"])
def test_quarantine_equals_the_jax_supervisor(tmp_path, how):
    """A corrupt newest checkpoint (flipped before the run, or by the
    fault script before attempt 1) is quarantined after the next
    no-progress failure, so the restart resumes from the step before; a
    hard kill that interrupted the only publish (no complete step
    directory: the resume can only refuse) has the incomplete directory
    quarantined and heals in one restart, as on the card; an incomplete
    newest directory beside a complete one is left alone (the resume
    skips it).  The progress reading is each package's default."""
    out = {}
    for pkg in ("port", "jax"):
        script = None
        if how.startswith("incomplete"):
            d = tmp_path / pkg
            if how == "incomplete_publish":
                d.mkdir()
                tckpt.save_sharded_checkpoint(d / "step_00000001", {"w": torch.ones(64)}, 0, 2)
            else:
                _step_dirs(d, complete=False)
            codes = [telastic.EXIT_KILLED, 0]
        else:
            d = _ckpt_dir(tmp_path / pkg)
            if how == "corrupted_before":
                PKGS[pkg][1].corrupt_newest_checkpoint(d)
            else:
                script = {"1": {"corrupt_newest_checkpoint": True}}
            codes = [1, 1, 0]
        out[pkg] = _drive(pkg, codes, ckdir=d, script=script, crash_loop_threshold=5,
                          real_progress=how.startswith("incomplete"))
    assert out["port"] == out["jax"]
    want = {"corrupted_before": ["step_00000002.ckpt"], "fault_script": ["step_00000002.ckpt"],
            "incomplete_publish": ["step_00000001"],
            "incomplete_newest_with_complete_sibling": []}[how]
    assert out["port"]["quarantined"] == want
    if how.startswith("incomplete"):
        assert out["port"]["restarts"] == 1 and out["port"]["rc"] == 0


@pytest.mark.parametrize("argv", [
    ["--steps", "4", "--supervise", "--max-restarts", "3", "--zero"],
    ["--supervise", "--fault-script=f.json", "--backoff-base", "0.5", "--keep", "2"],
    ["--backoff-seed=3", "--supervise-grace", "1", "--crash-loop-threshold", "2", "--eager"],
])
def test_strip_supervisor_argv_and_backoff_equal_jax(argv):
    assert tsup.strip_supervisor_argv(argv) == jsup.strip_supervisor_argv(argv)
    assert tsup.SUPERVISOR_FLAGS == jsup.SUPERVISOR_FLAGS
    for attempt in range(6):
        for seed in (0, 5):
            assert telastic.restart_backoff(attempt, 2.0, 30.0, seed) == \
                jelastic.restart_backoff(attempt, 2.0, 30.0, seed)


def test_validation():
    for kw in ({"crash_loop_threshold": 0}, {"max_restarts": -1}):
        with pytest.raises(ValueError):
            tsup.Supervisor(["x"], **kw)
    with pytest.raises(ValueError, match="no checkpoint_dir"):
        _drive("port", [1, 0], script={"0": {"corrupt_newest_checkpoint": True}})


TINY = ["--device", "cpu", "--layers", "2", "--hidden", "32", "--heads", "4", "--vocab", "64",
        "--seq", "16", "--global-batch", "4", "--steps", "3", "--zero", "--save-every", "1"]


def _pretrain(argv, tmp_path, name):
    res = subprocess.run([sys.executable, "-m", "apex_tpu_torch.pretrain_gpt", *argv],
                         cwd=REPO, capture_output=True, text=True, timeout=240)
    (tmp_path / f"{name}.err").write_text(res.stderr)
    reports = [json.loads(ln)["pretrain_gpt"] for ln in res.stdout.splitlines()
               if ln.startswith('{"pretrain_gpt"')]
    return res, reports


def test_supervised_pretrain_survives_a_kill_bitwise(tmp_path):
    script = tmp_path / "faults.json"
    script.write_text(json.dumps({"0": {"args": ["--chaos-kill-at-step", "1"]}}))
    res, reps = _pretrain(TINY + ["--checkpoint", str(tmp_path / "sup"), "--auto-resume",
                                  "--supervise", "--fault-script", str(script),
                                  "--backoff-base", "0.05"], tmp_path, "supervised")
    assert res.returncode == 0, res.stderr[-3000:]
    assert len(reps) == 1  # the killed child printed no report
    assert res.stderr.count("supervisor.restarting") == 1
    assert "chaos.host_killed" in res.stderr and '"exit_code": 137' in res.stderr
    # the unkilled run over every step the supervised job reached (a
    # restarted child takes --steps more from where it resumed: step 1
    # if the kill let step 1's checkpoint land, else 0)
    final = reps[0]
    assert final["start_step"] in (0, 1) and final["steps_done"] == 3
    clean_res, clean = _pretrain(TINY[:-5] + ["--steps", "4", "--zero", "--checkpoint",
                                              str(tmp_path / "clean"), "--save-every", "1"],
                                 tmp_path, "clean")
    assert clean_res.returncode == 0, clean_res.stderr[-3000:]
    want = dict(zip(clean[0]["steps"], clean[0]["losses"]))
    for s, loss in zip(final["steps"], final["losses"]):
        assert loss == want[s], (s, loss, want[s])  # bitwise: the same float
