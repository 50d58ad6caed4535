"""The port's GPT serving slice against the JAX package, on the CPU.

- RoPE angles bitwise and rotations within 1e-6;
- ``gpt_forward`` and ``forward_decode`` logits in fp32 (atol 1e-4: the
  two frameworks' CPU matmuls sum in other orders; the logits are
  O(1)), for learned and rope positions and for GQA, with the JAX
  params carried over by ``params_from_numpy``;
- the scheduler end to end on the tiny config of
  tests/test_inference.py: ``Completion.tokens`` equal to the JAX
  ``ContinuousBatchingScheduler``'s (xla impls, fp32) for greedy and
  for T=0.8, through page recycling;
- the package imports neither ``jax`` nor ``apex_tpu`` (an AST scan and
  a fresh interpreter's ``sys.modules``), and its entry points raise
  rather than fall back to the CPU when no GPU is present.
"""

import ast
import json
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
    alloc_pools as jax_alloc_pools, write_prompt_kv as jax_write_prompt_kv,
)
from apex_tpu.models import gpt as jgpt
from apex_tpu.ops import rope as jrope

from apex_tpu_torch import serve_gpt
from apex_tpu_torch.inference import (
    ContinuousBatchingScheduler, DecodeConfig, KVCacheConfig, Request, alloc_pools,
    write_prompt_kv,
)
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.ops import rope as trope

REPO = Path(__file__).resolve().parents[1]

TINY = dict(vocab_size=61, hidden_size=32, num_layers=2, num_attention_heads=4,
            max_seq_len=64, position_embedding_type="rope", checkpoint_layers=False)


def _configs(**kw):
    base = {**TINY, **kw}
    return (jgpt.GPTConfig(**base, compute_dtype=jnp.float32),
            tgpt.GPTConfig(**base, compute_dtype=torch.float32))


def _params(jcfg, tcfg, seed=0):
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jp)
    return jp, tgpt.params_from_numpy(tree, tcfg, device="cpu")


def test_rope_matches_jax_past_fp32_integer_range():
    """Angles bitwise (the same digit split and fp32 constants), and
    the rotations within 1e-6 (``cos``/``sin`` of two math libraries),
    at positions up to 2**31 - 1 where a plain fp32 cast would merge
    neighbours."""
    positions = np.asarray([0, 1, 17, 2 ** 24 + 1, 2 ** 24 + 2, 2 ** 31 - 1], np.int32)
    got = trope.rope_angles(torch.from_numpy(positions), 16)
    want = np.asarray(jrope.rope_angles(jnp.asarray(positions), 16))
    np.testing.assert_array_equal(got.numpy(), want)
    x = np.random.RandomState(3).randn(2, 3, len(positions), 16).astype(np.float32)
    np.testing.assert_allclose(
        trope.apply_rope(torch.from_numpy(x), torch.from_numpy(positions)).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(positions))),
        rtol=0, atol=1e-6)
    xd = x[0].transpose(1, 0, 2)  # (B=len(positions), nh, D): one position per row
    np.testing.assert_allclose(
        trope.apply_rope_at(torch.from_numpy(xd.copy()), torch.from_numpy(positions)).numpy(),
        np.asarray(jrope.apply_rope_at(jnp.asarray(xd), jnp.asarray(positions))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("pet,gqa", [("learned", None), ("rope", None), ("rope", 2)])
def test_gpt_forward_logits_match_jax(pet, gqa):
    jcfg, tcfg = _configs(position_embedding_type=pet, num_query_groups=gqa, num_layers=3)
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.RandomState(1).randint(0, 61, size=(2, 12))
    ref = np.asarray(jgpt.gpt_forward(jp, jnp.asarray(tokens), jcfg))
    got = tgpt.gpt_forward(tp, torch.from_numpy(tokens), tcfg)
    assert got.shape == ref.shape == (12, 2, 61)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def test_gpt_forward_kv_capture_matches_jax():
    jcfg, tcfg = _configs(num_query_groups=2)
    jp, tp = _params(jcfg, tcfg)
    tokens = np.random.RandomState(2).randint(0, 61, size=(1, 9))
    jh, (jk, jv) = jgpt.gpt_forward(jp, jnp.asarray(tokens), jcfg,
                                    return_hidden=True, return_kv=True)
    th, (tk, tv) = tgpt.gpt_forward(tp, torch.from_numpy(tokens), tcfg,
                                    return_hidden=True, return_kv=True)
    assert tk.shape == jk.shape == (2, 1, 2, 9, 8)
    for got, ref in ((th, jh), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("pet,gqa", [("learned", None), ("rope", None), ("rope", 2)])
def test_forward_decode_logits_match_jax(pet, gqa):
    """Prefill 5 positions, then decode 7 more one token at a time
    through the paged cache, in both packages."""
    jcfg, tcfg = _configs(position_embedding_type=pet, num_query_groups=gqa, num_layers=3)
    jp, tp = _params(jcfg, tcfg)
    S, prefix = 12, 5
    tokens = np.random.RandomState(1).randint(0, 61, size=(1, S))
    row = np.asarray([1, 2, 3, 4, 5], np.int32)
    jkc = JaxKVCacheConfig(num_pages=8, page_size=4, pages_per_seq=5, dtype=jnp.float32)
    tkc = KVCacheConfig(num_pages=8, page_size=4, pages_per_seq=5, dtype=torch.float32)

    _, (jk, jv) = jgpt.gpt_forward(jp, jnp.asarray(tokens), jcfg, return_kv=True)
    jpools = jax_alloc_pools(jcfg.num_layers, jcfg.kv_heads, jcfg.head_dim, jkc)
    kp, vp = jax_write_prompt_kv(
        jpools["k"], jpools["v"], jk[:, 0].transpose(0, 2, 1, 3)[:, :prefix],
        jv[:, 0].transpose(0, 2, 1, 3)[:, :prefix], jnp.asarray(row), jnp.int32(prefix))
    jpools = {"k": kp, "v": vp}

    _, (tk, tv) = tgpt.gpt_forward(tp, torch.from_numpy(tokens), tcfg, return_kv=True)
    tpools = alloc_pools(tcfg.num_layers, tcfg.kv_heads, tcfg.head_dim, tkc, device="cpu")
    write_prompt_kv(tpools["k"], tpools["v"], tk[:, 0].transpose(1, 2)[:, :prefix],
                    tv[:, 0].transpose(1, 2)[:, :prefix], torch.from_numpy(row), prefix)

    for pos in range(prefix, S):
        jh, jpools = jgpt.forward_decode(
            jp, jnp.asarray(tokens[:, pos]), jnp.asarray([pos], jnp.int32),
            jnp.asarray([True]), jpools, jnp.asarray(row)[None], jcfg, attn_impl="xla")
        th, tpools = tgpt.forward_decode(
            tp, torch.from_numpy(tokens[:, pos]), torch.tensor([pos]),
            torch.tensor([True]), tpools, torch.from_numpy(row)[None], tcfg)
        ref = np.asarray(jh) @ np.asarray(jp["embed"]).T
        got = (th.float() @ tp["embed"].T).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def _requests(rng, n, vocab, plen=(2, 7), max_new=(2, 6)):
    """The request trace of tests/test_inference.py, as (rid, prompt,
    max_new_tokens) triples."""
    out = []
    for i in range(n):
        prompt = [int(t) for t in rng.randint(0, vocab, size=rng.randint(*plen))]
        out.append((i, prompt, int(rng.randint(*max_new))))
    return out


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_scheduler_completions_match_jax(temperature):
    jcfg, tcfg = _configs()
    jp, tp = _params(jcfg, tcfg)
    trace = _requests(np.random.RandomState(7), 8, 61)
    jd = JaxDecodeConfig(
        cache=JaxKVCacheConfig(num_pages=10, page_size=4, pages_per_seq=6, dtype=jnp.float32),
        max_batch=3, max_prompt_len=8, temperature=temperature, attn_impl="xla",
        sample_impl="xla", sample_dot_dtype=jnp.float32, base_seed=5)
    td = DecodeConfig(
        cache=KVCacheConfig(num_pages=10, page_size=4, pages_per_seq=6, dtype=torch.float32),
        max_batch=3, max_prompt_len=8, temperature=temperature, base_seed=5)
    js = JaxScheduler(jp, jcfg, jd)
    ts = ContinuousBatchingScheduler(tp, tcfg, td, device="cpu")
    for rid, prompt, n in trace:
        js.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n))
        ts.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    jdone = {c.rid: c.tokens for c in js.run_until_drained()}
    tdone = {c.rid: c.tokens for c in ts.run_until_drained()}
    assert tdone == jdone
    assert ts.stats["admitted"] == 8 > td.max_batch, "pages must recycle"
    assert ts.stats["decode_steps"] == js.stats["decode_steps"]
    assert ts.allocator.free_pages == 9


def test_serve_gpt_main_on_cpu(capsys):
    assert serve_gpt.main(["--device", "cpu", "--layers", "2", "--hidden", "64",
                           "--heads", "4", "--vocab", "128", "--requests", "5",
                           "--streams", "2", "--prompt-len", "8", "--max-new", "3",
                           "--page-size", "4", "--top-k", "5"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 5 and out["generated_tokens"] == 15
    assert out["stats"]["prefills"] == 5


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="moe_num_experts"):
        tgpt.GPTConfig(moe_num_experts=4)
    with pytest.raises(NotImplementedError, match="sequence_parallel"):
        tgpt.GPTConfig(sequence_parallel=True)
    with pytest.raises(NotImplementedError, match="cp_overlap"):
        tgpt.GPTConfig(cp_overlap=True)
    for kw in ({"draft_len": 2}, {"prefill_chunk": 16}, {"prefix_sharing": True}):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            DecodeConfig(**kw)
    _, tcfg = _configs()
    tp = tgpt.init_params(tcfg, 0, device="cpu")
    sched = ContinuousBatchingScheduler(tp, tcfg, DecodeConfig(max_prompt_len=8), device="cpu")
    with pytest.raises(NotImplementedError, match="best_effort"):
        sched.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=2, lane="best_effort"))


def test_entry_points_raise_without_a_gpu():
    """With no CUDA device the default device raises: nothing runs on
    the CPU unless asked (this box has no GPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgpt.init_params(tcfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        alloc_pools(2, 4, 8, KVCacheConfig())
    tp = tgpt.init_params(tcfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingScheduler(tp, tcfg, DecodeConfig(max_prompt_len=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_gpt.main(["--layers", "1", "--hidden", "32", "--heads", "4", "--vocab", "64"])


def _forbidden(module: str) -> bool:
    return module in ("jax", "apex_tpu") or module.startswith(("jax.", "apex_tpu."))


def test_port_imports_no_jax_ast_scan():
    files = sorted((REPO / "apex_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), filename=str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(REPO)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad
    assert not _forbidden("apex_tpu_torch") and not _forbidden("apex_tpu_torch.ops")


def test_port_imports_no_jax_at_runtime():
    code = (
        "import sys, json\n"
        "import apex_tpu_torch, apex_tpu_torch.serve_gpt, apex_tpu_torch.inference\n"
        "import apex_tpu_torch.ops._build, apex_tpu_torch.ops.layer_norm\n"
        "import apex_tpu_torch.ops.decode_attention, apex_tpu_torch.ops.decode_sampling\n"
        "import apex_tpu_torch.train_gpt, apex_tpu_torch.ops.attention\n"
        "import apex_tpu_torch.ops.flash_attention, apex_tpu_torch.optimizers\n"
        "import apex_tpu_torch.models._remat, apex_tpu_torch.ops.fused_ce\n"
        "import apex_tpu_torch.ops.fused_ce_kernels, apex_tpu_torch.normalization\n"
        "print(json.dumps(sorted(m for m in sys.modules if m in ('jax', 'apex_tpu')\n"
        "    or m.startswith(('jax.', 'apex_tpu.')))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
