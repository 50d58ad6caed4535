"""The port's serving v2 (speculative verify, chunked prefill, prefix
sharing, the best-effort lane) against the JAX package, on the CPU, in
fp32.  It mirrors tests/test_serving_v2.py:

- the ``width > 1`` layout of paged decode attention (plain version)
  against ``decode_attention_xla`` and the Pallas kernel in interpret
  mode, widths 3 and 64, GQA (atol 1e-5: the frameworks and the online
  softmax sum in other orders);
- ``forward_decode(verify_width=W, write_mask=...)`` hidden states and
  pools against JAX (atol 1e-5, the same reason);
- ``NGramProposer`` and ``accepted_tokens`` against JAX's; a random
  ``PrefixCache`` trace against JAX's, operation by operation;
- the scheduler's completions equal to the JAX scheduler's token for
  token (xla impls, fp32 sampling dots), for speculation at T=0 and
  T=1 over rope, learned and GQA, eos mid-acceptance, a chunked long
  prompt, prefix sharing with copy-on-write, oversubscription, lanes
  with preemption and seed determinism across preemption; and inside
  the port, the speculative stream equal to the plain one;
- a tiny serving-v2 run of ``serve_gpt.main``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from apex_tpu.inference import (
    ContinuousBatchingScheduler as JaxScheduler, DecodeConfig as JaxDecodeConfig,
    KVCacheConfig as JaxKVCacheConfig, NGramProposer as JaxNGramProposer,
    PageAllocator as JaxPageAllocator, PrefixCache as JaxPrefixCache,
    Request as JaxRequest, accepted_tokens as jax_accepted_tokens,
    alloc_pools as jax_alloc_pools, write_prompt_kv as jax_write_prompt_kv,
)
from apex_tpu.models import gpt as jgpt
from apex_tpu.ops.decode_attention_pallas import (
    decode_attention_xla, paged_decode_attention_pallas,
)

from apex_tpu_torch import serve_gpt
from apex_tpu_torch.inference import (
    GARBAGE_PAGE, ContinuousBatchingScheduler, DecodeConfig, KVCacheConfig,
    NGramProposer, PageAllocator, PrefixCache, Request, accepted_tokens, alloc_pools,
    write_prompt_kv,
)
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.ops.decode_attention import (
    decode_attention_plain, paged_decode_attention,
)

TINY = dict(vocab_size=61, hidden_size=32, num_layers=2, num_attention_heads=4,
            max_seq_len=128, position_embedding_type="rope", checkpoint_layers=False)


def _configs(**kw):
    base = {**TINY, **kw}
    return (jgpt.GPTConfig(**base, compute_dtype=jnp.float32),
            tgpt.GPTConfig(**base, compute_dtype=torch.float32))


def _model(seed=0, **kw):
    """(jax config, jax params, port config, port params), the port's
    params carried over from the JAX tree."""
    jcfg, tcfg = _configs(**kw)
    jp = jgpt.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = tgpt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def model():
    return _model()


def _pair(m, *, num_pages=40, page_size=4, pages_per_seq=16, max_batch=3,
          temperature=0.0, top_k=0, max_prompt=16, seed=0, **dk):
    """A JAX scheduler (xla impls, fp32 sampling dots) and the port's,
    on one configuration, as tests/test_serving_v2.py builds them."""
    jcfg, jp, tcfg, tp = m
    cache = dict(num_pages=num_pages, page_size=page_size, pages_per_seq=pages_per_seq)
    common = dict(max_batch=max_batch, max_prompt_len=max_prompt, temperature=temperature,
                  top_k=top_k, base_seed=seed, **dk)
    jd = JaxDecodeConfig(cache=JaxKVCacheConfig(**cache, dtype=jnp.float32), attn_impl="xla",
                         sample_impl="xla", sample_dot_dtype=jnp.float32, **common)
    td = DecodeConfig(cache=KVCacheConfig(**cache, dtype=torch.float32), **common)
    return JaxScheduler(jp, jcfg, jd), ContinuousBatchingScheduler(tp, tcfg, td, device="cpu")


def _port_sched(m, **kw):
    return _pair(m, **kw)[1]


def _submit(scheds, rid, prompt, n, **kw):
    js, ts = scheds
    js.submit(JaxRequest(rid, list(prompt), n, **kw))
    ts.submit(Request(rid, list(prompt), n, **kw))


def _drain(scheds):
    """Run both until drained; their completions by rid, asserted equal."""
    js, ts = scheds
    want = {c.rid: tuple(c.tokens) for c in js.run_until_drained()}
    got = {c.rid: tuple(c.tokens) for c in ts.run_until_drained()}
    assert got == want, "the port's completions differ from the JAX scheduler's"
    return got


def _same_stats(scheds, *keys):
    js, ts = scheds
    assert {k: ts.stats[k] for k in keys} == {k: js.stats[k] for k in keys}


def _repetitive_prompt(rng, vocab, period=4, length=14):
    pat = rng.randint(0, vocab, size=period).tolist()
    return (pat * (length // period + 1))[:length]


# ------------------------------------------------- width attention
def _attn_case(rng, B, W, H, KVH, D=16, num_pages=30, page=8, P=12):
    q = rng.randn(B * W, H, D).astype(np.float32)
    kp = rng.randn(num_pages, page, KVH, D).astype(np.float32)
    vp = rng.randn(num_pages, page, KVH, D).astype(np.float32)
    pt = rng.randint(1, num_pages, size=(B, P)).astype(np.int32)
    lengths = rng.randint(0, page * P, size=(B * W,)).astype(np.int32)
    lengths[0] = 0  # an inactive row
    return q, kp, vp, pt, lengths


@pytest.mark.parametrize("B,W,H,KVH", [(2, 3, 4, 2), (2, 3, 4, 4), (1, 64, 4, 4),
                                       (1, 64, 6, 2), (3, 5, 4, 1)])
def test_width_attention_matches_jax_and_pallas(B, W, H, KVH):
    rng = np.random.RandomState(W + KVH)
    arrays = _attn_case(rng, B, W, H, KVH)
    out = paged_decode_attention(*map(torch.from_numpy, arrays), width=W)
    jargs = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(out.numpy(), np.asarray(decode_attention_xla(*jargs, width=W)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(paged_decode_attention_pallas(*jargs, width=W, interpret=True)),
        rtol=0, atol=1e-5)
    assert float(out[0].abs().max()) == 0.0, "a length-0 row must attend to nothing"


def test_width_layout_is_repeated_tables():
    """Scoring W consecutive rows against one shared table row equals
    width 1 with the table repeated, and each row alone at width 1."""
    rng = np.random.RandomState(0)
    q, kp, vp, pt, lengths = map(torch.from_numpy, _attn_case(rng, 2, 3, 4, 2))
    wide = decode_attention_plain(q, kp, vp, pt, lengths, width=3)
    flat = decode_attention_plain(q, kp, vp, pt.repeat_interleave(3, 0), lengths)
    np.testing.assert_allclose(wide.numpy(), flat.numpy(), rtol=0, atol=1e-6)
    qw, lw = q.reshape(2, 3, 4, 16), lengths.reshape(2, 3)
    for w in range(3):
        alone = paged_decode_attention(qw[:, w].contiguous(), kp, vp, pt,
                                       lw[:, w].contiguous())
        np.testing.assert_allclose(wide.reshape(2, 3, 4, 16)[:, w].numpy(), alone.numpy(),
                                   rtol=0, atol=1e-6)


def test_width_shape_mismatch_refuses():
    rng = np.random.RandomState(2)
    q, kp, vp, pt, lengths = map(torch.from_numpy, _attn_case(rng, 2, 3, 4, 2))
    for fn in (paged_decode_attention, decode_attention_plain):
        with pytest.raises(ValueError, match="width"):
            fn(q, kp, vp, pt, lengths, width=2)


# ------------------------------------------------- forward_decode
@pytest.mark.parametrize("pet,gqa", [("rope", None), ("learned", None), ("rope", 2)])
def test_forward_decode_verify_width_matches_jax(pet, gqa):
    """Two sequences with cached prefixes of 5 and 3 positions, then one
    3-wide verify forward; the second sequence's last row is inactive and
    its first row does not write (write_mask)."""
    jcfg, jp, tcfg, tp = _model(seed=1, position_embedding_type=pet,
                                num_query_groups=gqa, max_seq_len=64)
    W, P = 3, 4
    rng = np.random.RandomState(3)
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    prefix = (5, 3)
    jkc = JaxKVCacheConfig(num_pages=10, page_size=4, pages_per_seq=P, dtype=jnp.float32)
    tkc = KVCacheConfig(num_pages=10, page_size=4, pages_per_seq=P, dtype=torch.float32)
    jpools = jax_alloc_pools(jcfg.num_layers, jcfg.kv_heads, jcfg.head_dim, jkc)
    tpools = alloc_pools(tcfg.num_layers, tcfg.kv_heads, tcfg.head_dim, tkc, device="cpu")
    for b, n in enumerate(prefix):
        toks = rng.randint(0, 61, size=(1, n))
        _, (jk, jv) = jgpt.gpt_forward(jp, jnp.asarray(toks), jcfg, return_kv=True)
        kp, vp = jax_write_prompt_kv(jpools["k"], jpools["v"], jk[:, 0].transpose(0, 2, 1, 3),
                                     jv[:, 0].transpose(0, 2, 1, 3),
                                     jnp.asarray(tables[b]), jnp.int32(n))
        jpools = {"k": kp, "v": vp}
        _, (tk, tv) = tgpt.gpt_forward(tp, torch.from_numpy(toks), tcfg, return_kv=True)
        write_prompt_kv(tpools["k"], tpools["v"], tk[:, 0].transpose(1, 2),
                        tv[:, 0].transpose(1, 2), torch.from_numpy(tables[b]), n)
    tokens = rng.randint(0, 61, size=(2 * W,)).astype(np.int32)
    positions = np.asarray([5, 6, 7, 3, 4, 5], np.int32)
    active = np.asarray([1, 1, 1, 1, 1, 0], bool)
    wmask = np.asarray([1, 1, 1, 0, 1, 0], bool)
    jh, jpools = jgpt.forward_decode(
        jp, jnp.asarray(tokens), jnp.asarray(positions), jnp.asarray(active), jpools,
        jnp.asarray(tables), jcfg, attn_impl="xla", verify_width=W,
        write_mask=jnp.asarray(wmask))
    th, tpools = tgpt.forward_decode(
        tp, torch.from_numpy(tokens), torch.from_numpy(positions), torch.from_numpy(active),
        tpools, torch.from_numpy(tables), tcfg, verify_width=W,
        write_mask=torch.from_numpy(wmask))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    for name in ("k", "v"):  # page 0 is the garbage page: unordered duplicate writes
        np.testing.assert_allclose(tpools[name][:, 1:].numpy(),
                                   np.asarray(jpools[name])[:, 1:], rtol=0, atol=1e-5)
    # position 3 of sequence 1 was masked out of the writes: its slot is unwritten
    assert float(tpools["k"][:, 5, 3].abs().max()) == 0.0


# ------------------------------------------------- spec.py, prefix.py
def test_ngram_proposer_and_acceptance_match_jax():
    p = NGramProposer(draft_len=3, ngram_max=2, ngram_min=1)
    p.extend([5, 1, 2, 3, 9, 1, 2])
    assert p.propose() == [3, 9, 1]
    q = NGramProposer(draft_len=2)
    q.extend([1, 2, 3, 4])
    assert q.propose() == []
    assert accepted_tokens([7, 4, 5], [4, 5, 6]) == [4, 5, 6]
    assert accepted_tokens([7, 9, 5], [4, 5, 6]) == [4]
    assert accepted_tokens([7, 4, 9], [4, 5, 6]) == [4, 5]
    rng = np.random.RandomState(4)
    for trial in range(20):
        k, nmax = int(rng.randint(1, 5)), int(rng.randint(1, 4))
        nmin = int(rng.randint(1, nmax + 1))
        ours, theirs = NGramProposer(k, nmax, nmin), JaxNGramProposer(k, nmax, nmin)
        for _ in range(12):
            toks = rng.randint(0, 5, size=rng.randint(1, 4)).tolist()
            ours.extend(toks)
            theirs.extend(toks)
            assert ours.propose() == theirs.propose()
        drafted = rng.randint(0, 3, size=k + 1).tolist()
        sampled = rng.randint(0, 3, size=k + 1).tolist()
        assert accepted_tokens(drafted, sampled) == jax_accepted_tokens(drafted, sampled)


def test_prefix_cache_random_trace_matches_jax():
    """Random register / match / share / free / release operations on
    the port's trie and allocator and on JAX's: the same results, page
    for page, and no leak at the end."""
    rng = np.random.RandomState(5)
    N, ps = 24, 4
    ta, ja = PageAllocator(N), JaxPageAllocator(N)
    tc, jc = PrefixCache(ta, ps), JaxPrefixCache(ja, ps)
    bases = [rng.randint(0, 4, size=9).tolist() for _ in range(3)]
    live = []  # page lists a "resident" holds
    for _ in range(300):
        op = rng.randint(4)
        prompt = (bases[rng.randint(3)][:rng.randint(1, 10)]
                  + rng.randint(0, 4, size=rng.randint(0, 3)).tolist())
        if op == 0:
            m, jm = tc.match(prompt), jc.match(prompt)
            assert (m.full_pages, m.tail_page, m.shared_len) == (
                jm.full_pages, jm.tail_page, jm.shared_len)
            need = -(-len(prompt) // ps) - m.num_full
            got, want = ta.allocate(need), ja.allocate(need)
            assert got == want
            if got is not None:
                ta.share(m.full_pages)
                ja.share(m.full_pages)
                table = list(m.full_pages) + got
                assert tc.register(prompt, table) == jc.register(prompt, table)
                live.append((prompt, table))
        elif op == 1 and live:
            prompt, table = live.pop(rng.randint(len(live)))
            assert (tc.register(prompt, table, tail=True)
                    == jc.register(prompt, table, tail=True))
            ta.free(table)
            ja.free(table)
        elif op == 2:
            n = int(rng.randint(0, 6))
            assert tc.release(n) == jc.release(n)
        assert ta.free_pages == ja.free_pages
        assert tc.indexed_pages == jc.indexed_pages
        assert ta.refcount(GARBAGE_PAGE) == 0
        assert {p: ta.refcount(p) for p in range(N)} == {p: ja.refcount(p) for p in range(N)}
    for _, table in live:
        ta.free(table)
    tc.release(10 ** 6)
    assert ta.free_pages == N - 1, "pages leaked"


# ------------------------------------------------- scheduler: speculation
@pytest.mark.parametrize("pet,gqa,temperature,n", [
    ("rope", None, 0.0, 4), ("learned", None, 0.0, 4), ("rope", 2, 0.0, 4),
    ("rope", None, 1.0, 3)])
def test_spec_completions_match_jax_and_plain(pet, gqa, temperature, n):
    """Speculative serving equals the JAX scheduler's token for token,
    and, inside the port, the plain engine's stream (sampled too: with
    no more requests than slots every emission spends the seed the plain
    engine would), with more than one token a verify step."""
    m = _model(seed=1, position_embedding_type=pet, num_query_groups=gqa, max_seq_len=64)
    rng = np.random.RandomState(3)
    reqs = [(i, _repetitive_prompt(rng, 61), 8) for i in range(n)]
    kw = dict(temperature=temperature, top_k=7 if temperature else 0, seed=5)
    spec = _pair(m, draft_len=3, **kw)
    for r in reqs:
        _submit(spec, *r)
    got = _drain(spec)
    _same_stats(spec, "spec_steps", "spec_emitted", "decode_steps", "prefills")
    plain = _port_sched(m, **kw)
    for rid, prompt, k in reqs:
        plain.submit(Request(rid, list(prompt), k))
    assert {c.rid: tuple(c.tokens) for c in plain.run_until_drained()} == got
    ts = spec[1]
    assert ts.stats["spec_emitted"] / ts.stats["spec_steps"] > 1.0
    if temperature == 0.0:  # as in JAX: the greedy streams save whole steps
        assert ts.stats["decode_steps"] < plain.stats["decode_steps"]


def test_spec_eos_mid_acceptance_matches_jax(model):
    rng = np.random.RandomState(5)
    prompt = _repetitive_prompt(rng, 61)
    plain = _port_sched(model)
    plain.submit(Request(0, list(prompt), 10))
    toks = plain.run_until_drained()[0].tokens
    eos = toks[len(toks) // 2]
    spec = _pair(model, draft_len=3)
    _submit(spec, 0, prompt, 10, eos_id=eos)
    assert _drain(spec)[0] == tuple(toks[:toks.index(eos) + 1])


# ------------------------------------------------- scheduler: chunked prefill
def test_chunked_long_prompt_matches_jax_and_oneshot(model):
    rng = np.random.RandomState(13)
    prompt = rng.randint(0, 61, size=23).tolist()
    chunked = _pair(model, prefill_chunk=4, max_prompt=8)
    _submit(chunked, 0, prompt, 6)
    got = _drain(chunked)
    _same_stats(chunked, "chunk_steps", "prefills", "decode_steps")
    assert chunked[1].stats["chunk_steps"] == 6  # ceil(23 / 4)
    oneshot = _port_sched(model, max_prompt=32)
    oneshot.submit(Request(0, list(prompt), 6))
    assert tuple(oneshot.run_until_drained()[0].tokens) == got[0]
    with pytest.raises(ValueError, match="max_prompt_len"):
        oneshot.submit(Request(1, rng.randint(0, 61, size=40).tolist(), 2))


def test_chunks_interleave_with_decode_match_jax(model):
    """A resident stream keeps emitting while a long prompt
    chunk-prefills, step for step as in JAX."""
    rng = np.random.RandomState(14)
    pair = _pair(model, prefill_chunk=4, max_prompt=8, max_batch=2)
    _submit(pair, 0, rng.randint(0, 61, size=5).tolist(), 30)
    for s in pair:
        s.step()
    _submit(pair, 1, rng.randint(0, 61, size=20).tolist(), 3)
    for s in pair:
        s.step()
    ts = pair[1]
    resident = ts._slots[0]
    emitted = []
    while any(s is not None and s.chunk_next is not None for s in ts._slots):
        for s in pair:
            s.step()
        emitted.append(len(resident.generated))
    assert len(emitted) >= 2 and emitted[-1] > emitted[0]
    assert len(_drain(pair)) == 2


def test_shared_prefix_skips_chunk_compute_matches_jax(model):
    rng = np.random.RandomState(15)
    prompt = rng.randint(0, 61, size=12).tolist()  # 3 full pages
    pair = _pair(model, prefill_chunk=4, max_prompt=8, prefix_sharing=True)
    _submit(pair, 0, prompt, 4)
    _drain(pair)
    before = pair[1].stats["chunk_steps"]
    _submit(pair, 1, prompt, 4)
    done = _drain(pair)
    assert pair[1].stats["chunk_steps"] == before + 1
    assert done[0] == done[1]


# ------------------------------------------------- scheduler: prefix sharing
def test_full_pages_deduped_matches_jax(model):
    rng = np.random.RandomState(8)
    sysp = rng.randint(0, 61, size=8).tolist()  # exactly 2 full pages
    n = 3
    pair = _pair(model, prefix_sharing=True, max_batch=n)
    for i in range(n):
        _submit(pair, i, sysp + [i], 12)
    for s in pair:
        s.step()
    ts = pair[1]
    assert ts.num_active == n
    assert ts.allocator.live_pages == pair[0].allocator.live_pages == 6 + (n - 1) * 4
    assert ts.stats["shared_full_pages"] == 2 * (n - 1)
    shared = [int(p) for p in ts._page_tables[0, :2]]
    assert all(ts.allocator.refcount(p) == n + 1 for p in shared)
    _drain(pair)
    ts.prefix.release(10 ** 6)
    assert ts.allocator.free_pages == 39, "pages leaked"


def test_cow_matches_jax_and_unshared(model):
    rng = np.random.RandomState(9)
    prompt = rng.randint(0, 61, size=10).tolist()  # 2 pages + a tail
    pair = _pair(model, prefix_sharing=True)
    _submit(pair, 0, prompt, 5)
    _drain(pair)
    _submit(pair, 1, prompt, 5)
    got = _drain(pair)
    _same_stats(pair, "shared_tail_pages", "cow_copies", "shared_full_pages")
    assert pair[1].stats["cow_copies"] == 1
    plain = _port_sched(model)
    plain.submit(Request(1, list(prompt), 5))
    assert tuple(plain.run_until_drained()[0].tokens) == got[1]


def test_oversubscription_matches_jax(model):
    """A pool that fits one worst-case sequence unshared fits two with a
    shared prefix, in both packages."""
    rng = np.random.RandomState(10)
    sysp = rng.randint(0, 61, size=8).tolist()
    kw = dict(num_pages=6, page_size=4, pages_per_seq=3, max_batch=2)

    def max_resident(sharing):
        pair = _pair(model, prefix_sharing=sharing, **kw)
        for i in range(3):
            _submit(pair, i, sysp + [i], 3)
        peaks = [0, 0]
        for _ in range(200):
            if all(s.idle() for s in pair):
                break
            for j, s in enumerate(pair):
                s.step()
                peaks[j] = max(peaks[j], s.num_active)
        assert peaks[0] == peaks[1]
        assert len(_drain(pair)) == 3
        return peaks[1]

    assert max_resident(False) == 1
    assert max_resident(True) == 2


def test_trie_release_and_random_share_trace_match_jax(model):
    rng = np.random.RandomState(11)
    pair = _pair(model, prefix_sharing=True, num_pages=8, pages_per_seq=4, max_batch=1)
    for i in range(4):
        _submit(pair, i, rng.randint(0, 61, size=8).tolist(), 4)
    assert len(_drain(pair)) == 4
    assert pair[1].prefix.stats["released_pages"] == pair[0].prefix.stats["released_pages"] > 0
    rng = np.random.RandomState(12)
    pair = _pair(model, prefix_sharing=True, draft_len=2, num_pages=24,
                 pages_per_seq=10, max_batch=2)
    sysp = rng.randint(0, 61, size=9).tolist()
    rid = 0
    for _ in range(6):
        for _ in range(int(rng.randint(1, 4))):
            if rng.rand() < 0.6:
                prompt = sysp + rng.randint(0, 61, size=rng.randint(1, 4)).tolist()
            else:
                prompt = rng.randint(0, 61, size=rng.randint(2, 10)).tolist()
            _submit(pair, rid, prompt, int(rng.randint(1, 6)))
            rid += 1
        _drain(pair)
    ts = pair[1]
    assert ts.allocator.free_pages + ts.prefix.indexed_pages == 23, "pages leaked"
    ts.prefix.release(10 ** 6)
    assert ts.allocator.free_pages == 23


# ------------------------------------------------- scheduler: lanes
def test_preemption_matches_jax_and_full_forward(model):
    """Best-effort residents yield to the interactive head; every stream,
    preempted ones included, equals JAX's and the full forward's greedy
    continuation."""
    rng = np.random.RandomState(17)
    prompts = [rng.randint(0, 61, size=6).tolist() for _ in range(3)]
    pair = _pair(model, num_pages=9, page_size=4, pages_per_seq=8, max_batch=2)
    _submit(pair, 0, prompts[0], 8, lane="best_effort")
    _submit(pair, 1, prompts[1], 8, lane="best_effort")
    for s in pair:
        s.step()
    ts = pair[1]
    assert ts.num_active == 2 and ts.allocator.free_pages == 0
    _submit(pair, 2, prompts[2], 8, lane="interactive")
    done = _drain(pair)
    _same_stats(pair, "preemptions", "admitted", "evicted")
    assert ts.stats["preemptions"] >= 1 and set(done) == {0, 1, 2}
    assert all(len(t) == 8 for t in done.values())
    preempted = [c for c in ts.completed if c.preemptions]
    assert preempted and all(c.lane == "best_effort" for c in preempted)
    _, _, tcfg, tp = model
    for c in ts.completed:
        seq = list(c.prompt)
        for tok in c.tokens:
            logits = tgpt.gpt_forward(tp, [seq], tcfg)
            assert int(torch.argmax(logits[len(seq) - 1, 0])) == tok
            seq.append(tok)


def test_best_effort_waits_for_interactive_queue(model):
    rng = np.random.RandomState(18)
    sched = _port_sched(model, max_batch=1)
    sched.submit(Request(0, rng.randint(0, 61, size=4).tolist(), 3))
    sched.step()
    sched.submit(Request(1, rng.randint(0, 61, size=4).tolist(), 2, lane="best_effort"))
    sched.submit(Request(2, rng.randint(0, 61, size=4).tolist(), 2, lane="interactive"))
    order = []
    orig = sched._admit_into

    def record(slot, req, *plan):
        order.append(req.rid)
        return orig(slot, req, *plan)

    sched._admit_into = record
    sched.run_until_drained()
    assert order == [2, 1]
    with pytest.raises(ValueError, match="lane"):
        sched.submit(Request(3, [1, 2], 2, lane="bulk"))


# ------------------------------------------------- scheduler: seeds
def test_two_generations_one_slot_never_replay_a_seed(model):
    sched = _port_sched(model, max_batch=1, temperature=0.9, top_k=5, seed=11)
    used = []
    orig = sched._seed_at

    def spy(slot, draw):
        used.append((slot, draw))
        return orig(slot, draw)

    sched._seed_at = spy
    sched.submit(Request(0, [3, 4, 5], 4))
    g1 = sched.run_until_drained()[-1].tokens
    after_g1 = int(sched._draws[0])
    sched.submit(Request(1, [3, 4, 5], 4))
    g2 = sched.run_until_drained()[-1].tokens
    assert len(g1) == len(g2) == 4
    assert int(sched._draws[0]) == after_g1 + 4
    assert len(used) == len(set(used))


@pytest.mark.parametrize("draft_len", [0, 2])
def test_preemption_readmission_deterministic_matches_jax(model, draft_len):
    """One seeded trace with preemption in it, sampled: the port twice
    and JAX once give the same tokens (draw counters never reset on the
    preempt and re-admit path)."""
    def run():
        pair = _pair(model, num_pages=9, page_size=4, pages_per_seq=8, max_batch=2,
                     temperature=0.9, top_k=6, seed=13, draft_len=draft_len)
        rng = np.random.RandomState(20)
        _submit(pair, 0, rng.randint(0, 61, size=6).tolist(), 8, lane="best_effort")
        _submit(pair, 1, rng.randint(0, 61, size=6).tolist(), 8, lane="best_effort")
        for s in pair:
            s.step()
        _submit(pair, 2, rng.randint(0, 61, size=6).tolist(), 8)
        done = _drain(pair)
        assert pair[1].stats["preemptions"] >= 1
        return done

    assert run() == run()


# ------------------------------------------------- options and the load generator
def test_serving_v2_options_are_accepted():
    """The four options the first slices refused (``draft_len``,
    ``prefill_chunk``, ``prefix_sharing``, the best-effort lane) are
    accepted, and validated as in JAX."""
    d = DecodeConfig(draft_len=2, prefill_chunk=16, prefix_sharing=True,
                     ngram_max=4, ngram_min=2)
    assert (d.draft_len, d.prefill_chunk, d.prefix_sharing) == (2, 16, True)
    for kw, msg in (({"draft_len": -1}, "draft_len"), ({"prefill_chunk": 0}, "prefill_chunk"),
                    ({"ngram_min": 3, "ngram_max": 2}, "ngram_min")):
        with pytest.raises(ValueError, match=msg):
            DecodeConfig(**kw)
    _, tcfg = _configs()
    tp = tgpt.init_params(tcfg, 0, device="cpu")
    sched = ContinuousBatchingScheduler(tp, tcfg, DecodeConfig(max_prompt_len=8), device="cpu")
    sched.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=2, lane="best_effort"))
    assert list(sched.be_queue)[0].rid == 0
    assert len(sched.run_until_drained()) == 1


def test_make_requests_match_jax_example():
    """The same seed gives examples/gpt/serve_gpt.py's requests: system prompt,
    lengths, tokens and lanes drawn in its order."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "gpt" / "serve_gpt.py"
    spec = importlib.util.spec_from_file_location("jax_serve_gpt", path)
    jserve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jserve)
    argv = ["--requests", "12", "--system-prompt-len", "16", "--best-effort-frac", "0.5",
            "--prompt-len", "20", "--vocab", "100"]
    jr, _ = jserve.make_requests(jserve.build_args().parse_args(argv), np.random.RandomState(3))
    tr, _ = serve_gpt.make_requests(serve_gpt.build_args().parse_args(argv),
                                    np.random.RandomState(3))
    assert [(r.prompt, r.lane, r.max_new_tokens) for r in tr] == [
        (r.prompt, r.lane, r.max_new_tokens) for r in jr]
    assert {r.lane for r in tr} == {"interactive", "best_effort"}


def test_serve_gpt_main_serving_v2_on_cpu(capsys):
    assert serve_gpt.main(["--device", "cpu", "--layers", "2", "--hidden", "64",
                           "--heads", "4", "--vocab", "128", "--requests", "6",
                           "--streams", "3", "--prompt-len", "8", "--max-new", "5",
                           "--page-size", "4", "--draft-len", "2", "--prefill-chunk", "4",
                           "--prefix-sharing", "--system-prompt-len", "8",
                           "--best-effort-frac", "0.5"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    st = out["stats"]
    assert out["requests"] == 6 and out["generated_tokens"] == 30
    assert st["spec_steps"] > 0 and st["chunk_steps"] > 0 and st["prefills"] == 6
    assert st["decode_steps"] == st["spec_steps"]
    assert out["accepted_tokens_per_step"] == round(st["spec_emitted"] / st["spec_steps"], 3)
    assert 0 < out["page_dedupe_ratio"] <= 1
