"""The port's pipeline parallelism (``apex_tpu_torch.transformer
.pipeline_parallel``, ``transformer.microbatches``, ``parallel_state``'s
pp axis) against the JAX package.

Mirrors ``tests/test_pipeline_parallel.py``: on one world of 4 ranks
under gloo (``parallel.multiproc.launch``) the identity pipeline routes
the data; the 1F1B schedule's loss and grads of a toy stage function
(tanh layers, a squared-error head) match the JAX single-device oracle
(``jax.value_and_grad``) at pp 4 and at pp 2 with dp 2; the interleaved
schedule matches it at pp 4 and at pp 2 (vpp 2, the layers in the
stage-major order); the live microbatches of a rank stay at most P -
rank under 1F1B, and within the interleaved warm-up plus one, whatever M
is (the twin of ``TestMemoryBound``).  In this process: the
no-pipelining path against the oracle, the selector, the microbatch
calculators equal the JAX package's case by case, the pp axis's rank
layout against the JAX mesh's, and, for 1F1B and the interleaved order
at pp 2-4, that every pair of stages posts its messages on the one
pipeline group in the same order on both sides and that the exchanges
run to their end.  Bands: fp32; the loss within 1e-5
relative, the grads within 1e-4 relative and 1e-5 absolute (the JAX
test's).
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.transformer import microbatches as jmb
from apex_tpu.transformer import parallel_state as jps
from apex_tpu.transformer.pipeline_parallel import utils as jutils

from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.transformer import microbatches as tmb
from apex_tpu_torch.transformer.pipeline_parallel import utils as tutils
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
)

REPO = Path(__file__).resolve().parent.parent
L, H, MB = 8, 16, 3
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
#: the schedules run on the world: name -> (pp, vpp, microbatches, seed)
RUNS = {"pp4": (4, 1, 6, 1), "dp2_pp2": (2, 1, 4, 2), "pp4_vpp2": (4, 2, 8, 7),
        "pp2_vpp2": (2, 2, 4, 8)}
#: microbatch counts of the live-microbatch bound
BOUND_MS = (1, 2, 6, 24)
BOUND_MS_VPP = (4, 8, 24)


def make_problem(M, seed):
    rng = np.random.RandomState(seed)
    shared = {"w_in": rng.randn(H, H).astype(np.float32) * 0.3,
              "w_out": rng.randn(H).astype(np.float32) * 0.3}
    stages = {"w": rng.randn(L, H, H).astype(np.float32) * 0.3,
              "b": rng.randn(L, H).astype(np.float32) * 0.1}
    batch = {"x": rng.randn(M, MB, H).astype(np.float32),
             "y": rng.randn(M, MB).astype(np.float32)}
    return shared, stages, batch


def stage_major(a, pp, vpp):
    """Stage s's chunks s, s + pp, ... back to back (the layout the
    interleaved schedule shards)."""
    lpc = a.shape[0] // (pp * vpp)
    return a.reshape(vpp, pp, lpc, *a.shape[1:]).swapaxes(0, 1).reshape(a.shape)


def jax_oracle(shared, stages, batch):
    """The JAX single-device loss and grads (shared, stages)."""
    def pre(sh, mb):
        return jnp.tanh(mb["x"] @ sh["w_in"])

    def stage(sp, h):
        return jax.lax.scan(lambda c, lp: (jnp.tanh(c @ lp["w"] + lp["b"]), None), h, sp)[0]

    def post(sh, h, mb):
        return jnp.mean((h @ sh["w_out"] - mb["y"]) ** 2)

    def loss(sh, st, b):
        return jnp.mean(jax.vmap(lambda mb: post(sh, stage(st, pre(sh, mb)), mb))(b))

    val, (gs, gst) = jax.value_and_grad(loss, argnums=(0, 1))(shared, stages, batch)
    return float(val), jax.tree.map(np.asarray, gs), jax.tree.map(np.asarray, gst)


def pre_fn(sh, mb):
    return torch.tanh(mb["x"] @ sh["w_in"])


def stage_fn(sp, h):
    for i in range(sp["w"].shape[0]):
        h = torch.tanh(h @ sp["w"][i] + sp["b"][i])
    return h


def post_fn(sh, h, mb):
    return torch.mean((h @ sh["w_out"] - mb["y"]) ** 2)


CHILD = r'''
import sys, pickle
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from apex_tpu_torch.parallel import initialize_distributed, destroy_distributed
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
    broadcast_from_last_stage, forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving, interleaved_pipelined_apply,
    make_pipeline_loss_fn, pipelined_apply)
from apex_tpu_torch.transformer.pipeline_parallel.utils import calc_params_l2_norm
from test_torch_pipeline_parallel import post_fn, pre_fn, stage_fn, stage_major
problems, runs, BOUND_MS, BOUND_MS_VPP, H, MB = pickle.load(open(sys.argv[3], "rb"))
initialize_distributed("cpu")
out = {"rank": dist.get_rank()}
T = lambda a: torch.tensor(a).requires_grad_(True)


def init(pp, vpp=1):
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(pipeline_model_parallel_size_=pp,
                                 virtual_pipeline_model_parallel_size_=vpp if vpp > 1 else None)
    return ps.get_pipeline_model_parallel_rank()


def run(pp, vpp, shared, stages, batch, forward_only=False, log=None):
    s = init(pp, vpp)
    lpc = stages["w"].shape[0] // (pp * vpp)
    st = {k: T(stage_major(v, pp, vpp)[s * vpp * lpc:(s + 1) * vpp * lpc])
          for k, v in stages.items()}
    sh = {k: T(v) for k, v in shared.items()}
    mbs = {k: torch.tensor(v) for k, v in batch.items()}
    kw = dict(tensor_shape=(MB, H), dtype=torch.float32, forward_only=forward_only,
              schedule_log=log)
    if vpp == 1:
        return forward_backward_pipelining_without_interleaving(pre_fn, stage_fn, post_fn, sh,
                                                                st, mbs, **kw)
    return forward_backward_pipelining_with_interleaving(
        pre_fn, stage_fn, post_fn, sh, st, mbs, virtual_pipeline_model_parallel_size=vpp, **kw)


# the parallel_state layout at pp 4 and at dp 2 x pp 2 (tp 1), and 2 x 2
# with tp 2
layout = {}
for tp, pp in ((1, 4), (1, 2), (2, 2)):
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tensor_model_parallel_size_=tp, pipeline_model_parallel_size_=pp)
    layout[tp, pp] = dict(
        pp_rank=ps.get_pipeline_model_parallel_rank(), tp_rank=ps.get_tensor_model_parallel_rank(),
        dp_rank=ps.get_data_parallel_rank(), pipe=ps.get_pipeline_model_parallel_group().ranks,
        next=ps.get_pipeline_model_parallel_next_rank(),
        prev=ps.get_pipeline_model_parallel_prev_rank(),
        first=ps.get_pipeline_model_parallel_first_rank(),
        last=ps.get_pipeline_model_parallel_last_rank(),
        is_first=ps.is_pipeline_first_stage(), is_last=ps.is_pipeline_last_stage(),
        embedding=ps.get_embedding_group().ranks,
        position_embedding=ps.get_position_embedding_group().ranks,
        in_embedding=ps.is_rank_in_embedding_group(),
        in_position_embedding=ps.is_rank_in_position_embedding_group(),
        info=ps.get_rank_info())
out["layout"] = layout

# the identity pipeline: each stage adds 1
init(4)
xs = torch.arange(12.0).reshape(6, 2)
out["identity"] = broadcast_from_last_stage(pipelined_apply(lambda p, x: x + 1.0, None, xs))
out["identity_vpp"] = broadcast_from_last_stage(
    interleaved_pipelined_apply(lambda p, x: x + float(p["s"].sum()), {"s": torch.ones(2, 1)},
                                xs, 2))

for name, (pp, vpp, M, seed) in runs.items():
    shared, stages, batch = problems[name]
    loss, (gs, gst) = run(pp, vpp, shared, stages, batch)
    fwd, _ = run(pp, vpp, shared, stages, batch, forward_only=True)
    out[name] = (float(loss), float(fwd), {k: v.numpy() for k, v in gs.items()},
                 {k: v.numpy() for k, v in gst.items()})
shared, stages, batch = problems["pp4"]
init(4)
st = {k: torch.tensor(v[2 * ps.get_pipeline_model_parallel_rank():][:2]) for k, v in stages.items()}
out["loss_fn"] = float(make_pipeline_loss_fn(pre_fn, stage_fn, post_fn)(
    {k: torch.tensor(v) for k, v in shared.items()}, st,
    {k: torch.tensor(v) for k, v in batch.items()}))
out["l2norm"] = float(calc_params_l2_norm(st, axis_name=ps.get_pipeline_model_parallel_group()))

# the live microbatches (units in flight at each backward)
live = {}
for pp, vpp, ms in ((4, 1, BOUND_MS), (2, 1, BOUND_MS), (4, 2, BOUND_MS_VPP),
                    (2, 2, BOUND_MS_VPP)):
    for M in ms:
        shared, stages, batch = problems["bound", M]
        log = []
        run(pp, vpp, shared, stages, batch, log=log)
        live[pp, vpp, M] = (max(e[3] for e in log if e[0] == "B"),
                            [e[:3] for e in log])
out["live"] = live
torch.save(out, sys.argv[2] + f"/rank{dist.get_rank()}.pt")
destroy_distributed()
'''


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    problems = {name: make_problem(M, seed) for name, (_, _, M, seed) in RUNS.items()}
    problems.update({("bound", M): make_problem(M, 0) for M in set(BOUND_MS + BOUND_MS_VPP)})
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((problems, RUNS, BOUND_MS, BOUND_MS_VPP, H, MB), f)
    multiproc.launch(["-c", CHILD, str(REPO), str(d), str(d / "in.pkl")], 4, timeout=400,
                     env={"PYTHONPATH": str(REPO / "tests")})
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(4)], problems


def test_identity_pipeline_routes_data(world4):
    """Each of 4 stages adds 1: every rank holds xs + 4 after the broadcast
    from the last stage; through 2 chunks of 4 stages (each adding 1 once
    per chunk) xs + 8."""
    res, _ = world4
    xs = torch.arange(12.0).reshape(6, 2)
    for r in res:
        torch.testing.assert_close(r["identity"], xs + 4, rtol=0, atol=0)
        torch.testing.assert_close(r["identity_vpp"], xs + 8, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_schedule_matches_the_jax_oracle(world4, name):
    """The 1F1B (pp 4; pp 2 at dp 2) and interleaved (vpp 2 at pp 4 and 2)
    schedules: the loss on every rank, forward-only too, the shared grads
    (summed over the stages) and each stage's layer grads against JAX's
    single-device value_and_grad."""
    res, problems = world4
    pp, vpp, M, _ = RUNS[name]
    shared, stages, batch = problems[name]
    loss, gs, gst = jax_oracle(shared, stages, batch)
    lpc = L // (pp * vpp)
    for r in res:
        got_loss, fwd_loss, got_gs, got_gst = r[name]
        s = r["layout"][1, pp]["pp_rank"]
        np.testing.assert_allclose(got_loss, loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(fwd_loss, loss, rtol=LOSS_RTOL)
        for k in gs:
            np.testing.assert_allclose(got_gs[k], gs[k], **GRAD_TOL)
        for k in gst:
            want = stage_major(gst[k], pp, vpp)[s * vpp * lpc:(s + 1) * vpp * lpc]
            np.testing.assert_allclose(got_gst[k], want, **GRAD_TOL)


def test_forward_only_loss_fn_and_l2norm(world4):
    """``make_pipeline_loss_fn`` (forward only, broadcast from the last
    stage) and ``calc_params_l2_norm`` over the pipeline against the
    whole model's loss and norm."""
    res, problems = world4
    shared, stages, batch = problems["pp4"]
    loss, _, _ = jax_oracle(shared, stages, batch)
    norm = float(jutils.calc_params_l2_norm(jax.tree.map(jnp.asarray, stages)))
    for r in res:
        np.testing.assert_allclose(r["loss_fn"], loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["l2norm"], norm, rtol=1e-6)


def test_live_microbatches_stay_bounded(world4):
    """1F1B keeps at most P - rank microbatches in flight on a rank (min
    with M), whatever M is; the interleaved schedule at most its warm-up
    plus one, ``(P - rank - 1)·2 + (vpp - 1)·P + 1`` (all M·vpp units
    when M = P).  Each rank runs every forward and backward once, the
    backwards of a chunk in microbatch order."""
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.tick_schedule import (
        interleaved_warmup,
    )

    res, _ = world4
    for r in res:
        for (pp, vpp, M), (peak, log) in r["live"].items():
            rank = r["layout"][1, pp]["pp_rank"]
            if vpp == 1:
                assert peak == min(pp - rank, M), (pp, M, rank, peak)
            else:
                assert peak <= interleaved_warmup(pp, rank, vpp, M) + 1, (pp, vpp, M, peak)
                assert peak <= (pp - rank - 1) * 2 + (vpp - 1) * pp + 1 or M == pp
            for kind in "FB":
                units = [(v, m) for k, v, m in log if k == kind]
                assert sorted(units) == [(v, m) for v in range(vpp) for m in range(M)]
                for v in range(vpp):
                    assert [m for c, m in units if c == v] == list(range(M))


def test_parallel_state_pp_layout_matches_the_jax_mesh(world4, devices8):
    """Rank r's (dp, pp, tp) coordinates are those of device r of the JAX
    mesh (``AXIS_ORDER``), its pipeline holds the ranks of its (dp, tp)
    column, the ring's neighbours, the first and last stages, and the
    embedding groups {first, last} and {first}."""
    res, _ = world4
    for tp, pp in ((1, 4), (1, 2), (2, 2)):
        mesh = jps.initialize_model_parallel(tensor_model_parallel_size_=tp,
                                             pipeline_model_parallel_size_=pp,
                                             devices=devices8[:4])
        try:
            ids = np.vectorize(lambda d: d.id)(mesh.devices)  # (dp, pp, cp, tp)
            assert jps.get_rank_info() == res[0]["layout"][tp, pp]["info"]
        finally:
            jps.destroy_model_parallel()
        for r in res:
            lay = r["layout"][tp, pp]
            d, p, t = lay["dp_rank"], lay["pp_rank"], lay["tp_rank"]
            assert ids[d, p, 0, t] == devices8[r["rank"]].id
            pipe = [int(ids[d, q, 0, t]) for q in range(pp)]
            assert list(lay["pipe"]) == pipe
            assert (lay["next"], lay["prev"]) == (pipe[(p + 1) % pp], pipe[(p - 1) % pp])
            assert (lay["first"], lay["last"]) == (pipe[0], pipe[-1])
            assert (lay["is_first"], lay["is_last"]) == (p == 0, p == pp - 1)
            assert list(lay["embedding"]) == ([pipe[0], pipe[-1]] if p in (0, pp - 1) else [])
            assert list(lay["position_embedding"]) == ([pipe[0]] if p == 0 else [])
            assert lay["in_embedding"] == (p in (0, pp - 1))
            assert lay["in_position_embedding"] == (p == 0)


#: (pp, vpp, microbatches) of the message-order check
ORDER_CASES = [(P, 1, M) for P in (2, 3, 4) for M in (1, 2, 3, 5, 8)] + \
    [(P, vpp, M) for P in (2, 3, 4) for vpp in (2, 3) for M in (P, 2 * P, 3 * P)]


class _OneRank:
    """The ``AxisGroup`` interface of rank ``r`` of a P-stage pipeline,
    with no process group."""

    def __init__(self, P, r):
        self.P, self.r, self.ranks, self.group = P, r, tuple(range(P)), None

    def size(self):
        return self.P

    def rank(self):
        return self.r


def _exchanges(monkeypatch, P, rank, vpp, M):
    """The exchanges rank ``rank`` posts in one step of the schedule, each
    the list of ``(op, peer, what)`` in ``_communicate``'s order."""
    from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication as p2p
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import tick_schedule as ts

    program = []

    def record(send_next, send_prev, recv_prev, recv_next, shape, dtype, device, group=None):
        program.append(p2p.exchange_ops(rank, P, send_next is not None, recv_prev,
                                        send_prev is not None, recv_next))
        return (torch.zeros(shape) if recv_prev else None,
                torch.zeros(shape) if recv_next else None)

    monkeypatch.setattr(p2p, "_communicate", record)
    shared = {"w": torch.ones(H, H, requires_grad=True)}
    stages = {"w": torch.ones(vpp, H, requires_grad=True)}
    u = ts._Units(lambda sh, mb: mb @ sh["w"], lambda c, x: x * c["w"].sum(0),
                  lambda sh, y, mb: (y @ sh["w"]).sum(), shared, stages,
                  torch.ones(M, MB, H), vpp, P, rank, False, None)
    spec = ((MB, H), torch.float32, torch.device("cpu"), _OneRank(P, rank))
    (ts._one_f_one_b if vpp == 1 else ts._interleaved)(u, spec)
    return program


@pytest.mark.parametrize("case", ORDER_CASES, ids=lambda c: "pp%d_vpp%d_m%d" % c)
def test_one_group_carries_every_message_in_order(monkeypatch, case):
    """One process group carries activations and cotangents both ways.
    NCCL and gloo match the messages between two ranks in the order they
    were posted, so for every ordered pair of stages the sender's
    sequence of activations and cotangents must be the receiver's (at pp
    2 the previous and the next stage are one rank); and with each
    exchange one NCCL group, in order on the group's stream, the ranks'
    programs must run to their ends: an exchange completes once the
    exchanges that hold its matches have been reached on the peers."""
    P, vpp, M = case
    progs = [_exchanges(monkeypatch, P, r, vpp, M) for r in range(P)]
    for a in range(P):
        for b in range(P):
            sent = [w for ex in progs[a] for op, peer, w in ex if op == "send" and peer == b]
            got = [w for ex in progs[b] for op, peer, w in ex if op == "recv" and peer == a]
            assert sent == got, (a, b, sent, got)
    # the n-th message of a kind between a pair is the n-th of the other side
    where = []
    for r in range(P):
        seen, at = {}, {}
        for i, ex in enumerate(progs[r]):
            for op, peer, _ in ex:
                n = seen.get((op, peer), 0)
                seen[op, peer] = n + 1
                at[op, peer, n] = i
        where.append(at)
    index = [[[] for _ in prog] for prog in progs]
    for r in range(P):
        for (op, peer, n), i in where[r].items():
            index[r][i].append((op, peer, n))
    cur = [0] * P
    while any(cur[r] < len(progs[r]) for r in range(P)):
        moved = False
        for r in range(P):
            if cur[r] < len(progs[r]) and all(
                    where[peer]["recv" if op == "send" else "send", r, n] <= cur[peer]
                    for op, peer, n in index[r][cur[r]]):
                cur[r] += 1
                moved = True
        assert moved, f"the exchanges stall at {cur} of {[len(p) for p in progs]}"


def test_interleaved_schedule_is_refused_over_nccl(monkeypatch):
    """The refusal is gone: vpp 2 over an NCCL pipeline group builds its
    step, as over gloo (ROADMAP.md section 3: GPT-345M vpp 2 ran 10 graphed
    steps at pp 2 and pp 4 on four H100s within 5.3e-5 of pp 1 and tore
    down in 1.2-1.4 s)."""
    import torch.distributed as dist

    from apex_tpu_torch.models import gpt as tgpt
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import tick_schedule as ts

    assert not hasattr(ts, "check_interleaved_backend")
    group = _OneRank(2, 0)
    group.group = object()
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=4, num_attention_heads=4,
                         max_seq_len=16)
    for backend in ("nccl", "gloo"):
        monkeypatch.setattr(dist, "get_backend", lambda group=None, b=backend: b)
        assert callable(tgpt.make_pp_train_step(cfg, FusedAdam(lr=1e-3), 2, 2, pp_group=group,
                                                graphs=False))


@pytest.mark.parametrize("P", [2, 4])
def test_interleaved_schedule_posts_every_exchange(monkeypatch, P):
    """``pipelined_fwd_bwd`` with vpp 2 over a gloo pipeline group posts
    every exchange of its program (rank 0's, as :func:`_exchanges` lists
    it) and returns the loss and the grads."""
    import torch.distributed as dist

    from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication as p2p
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import tick_schedule as ts

    group = _OneRank(P, 0)
    group.group = object()
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "all_reduce", lambda t, group=None: None)
    monkeypatch.setattr(ts, "_warm", lambda group, device: None)
    posted = []

    def record(send_next, send_prev, recv_prev, recv_next, shape, dtype, device, group=None):
        posted.append((send_next is not None, recv_prev, send_prev is not None, recv_next))
        return (torch.zeros(shape) if recv_prev else None,
                torch.zeros(shape) if recv_next else None)

    monkeypatch.setattr(p2p, "_communicate", record)
    shared = {"w": torch.ones(H, H, requires_grad=True)}
    stages = {"w": torch.ones(2, H, requires_grad=True)}
    loss, (g_sh, g_st) = ts.pipelined_fwd_bwd(
        lambda sh, mb: mb @ sh["w"], lambda c, x: x * c["w"].sum(0),
        lambda sh, y, mb: (y @ sh["w"]).sum(), shared, stages, torch.ones(P, MB, H),
        tensor_shape=(MB, H), dtype=torch.float32, num_chunks=2, axis_name=group)
    want = _exchanges(monkeypatch, P, 0, 2, P)
    assert len(posted) == len(want) > 0
    assert g_st["w"].shape == (2, H) and loss.dim() == 0


@pytest.mark.parametrize("vpp,tp,backend,refused", [
    (2, 1, "nccl", None),
    (1, 2, "nccl", None),
    (1, 1, "nccl", None),
    (2, 2, "gloo", None),
])
def test_make_pp_train_step_refuses_vpp_and_tp_over_nccl(monkeypatch, vpp, tp, backend,
                                                         refused):
    """``make_pp_train_step`` over a pipeline group on NCCL builds its step
    with vpp > 1 and with tp > 1, as over gloo: both refusals are gone
    (ROADMAP.md section 3: the tp 2 x pp 2 NaN was the CE forward kernel's,
    fixed, and vpp ran to its end on four H100s)."""
    import torch.distributed as dist

    from apex_tpu_torch.models import gpt as tgpt
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.parallel_state import AxisGroup

    group = _OneRank(2, 0)
    group.group = object()
    tp_group = AxisGroup("tp", object(), tp, 0, range(tp))
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=4, num_attention_heads=4,
                         max_seq_len=16)

    def build():
        return tgpt.make_pp_train_step(cfg, FusedAdam(lr=1e-3), 2, vpp, pp_group=group,
                                       tp_group=tp_group, graphs=False)

    if refused:
        with pytest.raises(NotImplementedError, match=f"{refused}.*ROADMAP.md section 3"):
            build()
    else:
        assert callable(build())


def test_release_graphs_before_the_group_is_destroyed():
    """``destroy_distributed`` frees every live captured graph first (a
    graph holding captured NCCL work kept ``destroy_process_group``
    waiting on four H100s, ROADMAP.md section 3); a released step raises
    when called again."""
    from apex_tpu_torch import graphs
    from apex_tpu_torch.graphs import CapturedStep
    from apex_tpu_torch.parallel import multiproc

    class FakeGraph:
        resets = 0

        def reset(self):
            FakeGraph.resets += 1

    step = CapturedStep(lambda x: x + 1)
    assert float(step(torch.ones(()))) == 2.0  # the CPU path: no graph
    step.graph = FakeGraph()
    graphs._LIVE.add(step)
    multiproc.initialize_distributed("cpu")
    multiproc.destroy_distributed()
    assert FakeGraph.resets == 1 and step.graph is None and step.released
    assert not list(graphs._LIVE)
    with pytest.raises(RuntimeError, match="released"):
        step(torch.ones(()))
    assert graphs.release_graphs() == 0


def test_no_pipelining_matches_the_oracle_and_the_selector():
    shared, stages, batch = make_problem(6, 2)
    loss, gs, gst = jax_oracle(shared, stages, batch)
    params = {"shared": {k: torch.tensor(v).requires_grad_(True) for k, v in shared.items()},
              "stages": {k: torch.tensor(v).requires_grad_(True) for k, v in stages.items()}}

    def step_fn(p, mb):
        return post_fn(p["shared"], stage_fn(p["stages"], pre_fn(p["shared"], mb)), mb)

    mbs = {k: torch.tensor(v) for k, v in batch.items()}
    losses, grads = forward_backward_no_pipelining(step_fn, mbs, params)
    np.testing.assert_allclose(float(losses.mean()), loss, rtol=LOSS_RTOL)
    for want, got in ((gs, grads["shared"]), (gst, grads["stages"])):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], **GRAD_TOL)
    fwd, none = forward_backward_no_pipelining(step_fn, mbs, params, forward_only=True)
    assert none is None
    torch.testing.assert_close(fwd, losses)
    assert get_forward_backward_func(None, 1) is forward_backward_no_pipelining
    assert get_forward_backward_func(None, 4) is forward_backward_pipelining_without_interleaving
    assert get_forward_backward_func(2, 4) is forward_backward_pipelining_with_interleaving


CALCULATOR_CASES = [
    (None, 16, 2, 2), (None, 8, 1, 8), (None, 12, 2, 3), (None, 10, 3, 1),
    ([4, 4, 100], 16, 2, 2), ([2, 2, 30], 10, 1, 2), ([8, 8, 64], 32, 4, 2),
    ([4, 4, 100, 7], 16, 2, 2), ([6, 4, 40], 16, 2, 1), ([8, 0, 10], 16, 2, 2),
]


@pytest.mark.parametrize("case", range(len(CALCULATOR_CASES)))
def test_microbatch_calculators_equal_jax(case):
    """Each case through both packages' ``build_num_microbatches_calculator``
    and a walk of ``update`` over consumed samples (with the consistency
    check): the same counts, batch sizes, or the same exception."""
    rampup, gbs, mbs, dp = CALCULATOR_CASES[case]

    def walk(mod):
        try:
            c = mod.build_num_microbatches_calculator(0, rampup, gbs, mbs, dp)
            seen = [(c.get(), c.get_current_global_batch_size())]
            for consumed in (0, 1, 7, 25, 33, 50, 64, 99, 100, 101, 1000):
                for check in (False, True):
                    try:
                        c.update(consumed, check)
                        seen.append((consumed, check, c.get(),
                                     c.get_current_global_batch_size()))
                    except AssertionError as e:
                        seen.append((consumed, check, "AssertionError", str(e)))
            return seen
        except (ValueError, AssertionError, ZeroDivisionError) as e:
            return (type(e).__name__, str(e))

    assert walk(tmb) == walk(jmb)


def test_microbatch_utilities(monkeypatch):
    """``setup_microbatch_calculator`` and its getters as the JAX
    package's; ``get_kth_microbatch`` slices each leaf; the timers."""
    for mod in (tutils, jutils):
        mod.destroy_num_microbatches_calculator()
        mod.setup_microbatch_calculator(0, [4, 4, 100], 16, 2, 2)
        with pytest.raises(AssertionError, match="already initialized"):
            mod.setup_microbatch_calculator(0, None, 16, 2, 2)
    assert (tutils.get_num_microbatches(), tutils.get_current_global_batch_size(),
            tutils.get_micro_batch_size()) == (
        jutils.get_num_microbatches(), jutils.get_current_global_batch_size(),
        jutils.get_micro_batch_size())
    for mod in (tutils, jutils):
        mod.update_num_microbatches(60)
    assert tutils.get_num_microbatches() == jutils.get_num_microbatches()
    batch = {"t": torch.arange(12).reshape(6, 2)}
    np.testing.assert_array_equal(tutils.get_kth_microbatch(batch, 1)["t"].numpy(),
                                  np.asarray(jutils.get_kth_microbatch(
                                      {"t": jnp.arange(12).reshape(6, 2)}, 1)["t"]))
    for mod in (tutils, jutils):
        mod.destroy_num_microbatches_calculator()
    timers = tutils.get_timers()
    timers("a").start()
    assert timers("a").elapsed() >= 0.0
    assert tutils.listify_model(3) == [3] and tutils.get_autoresume() is None
    tutils.print_rank_0("rank 0 prints")
    tutils.report_memory("cpu")
    from apex_tpu_torch.transformer.pipeline_parallel import build_model

    assert build_model(lambda: 1) == [1]
    assert build_model(lambda k=0: k, virtual_pipeline_model_parallel_size=3, k=2) == [2, 2, 2]
