"""The port's paged KV cache (apex_tpu_torch.inference.kv_cache) against
the JAX package's: the page allocator step for step, and the decode
and prompt writes on the same pools (exact: the writes move values,
they compute nothing).  The port writes in place; JAX returns new
pools."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from apex_tpu.inference import kv_cache as jkv

from apex_tpu_torch.inference import kv_cache as tkv


def _ops(rng, n=200):
    """A random trace of allocate / share / free calls."""
    return [(["allocate", "share", "free"][rng.randint(3)], int(rng.randint(1, 5)))
            for _ in range(n)]


def _apply(alloc, op, n, live, rng_state):
    """Apply one op to an allocator; returns what it produced (or the
    error text) so two allocators can be compared step by step."""
    try:
        if op == "allocate":
            got = alloc.allocate(n)
            if got is not None:
                live.extend(got)
            return ("ok", got)
        if not live:
            return ("skip", None)
        pages = [live[i % len(live)] for i in rng_state.randint(0, 1000, size=n)]
        if op == "share":
            alloc.share(pages[:1])
            live.append(pages[0])
            return ("ok", None)
        alloc.free(pages[:1])
        live.remove(pages[0])
        return ("ok", None)
    except ValueError as exc:
        return ("error", str(exc))


def test_allocator_trace_matches_jax():
    rng = np.random.RandomState(0)
    ja, ta = jkv.PageAllocator(12), tkv.PageAllocator(12)
    jl, tl = [], []
    for op, n in _ops(rng):
        seed = int(rng.randint(1 << 30))
        a = _apply(ja, op, n, jl, np.random.RandomState(seed))
        b = _apply(ta, op, n, tl, np.random.RandomState(seed))
        assert a == b, (op, n)
        assert (ja.free_pages, ja.live_pages) == (ta.free_pages, ta.live_pages)
        assert all(ja.refcount(p) == ta.refcount(p) for p in range(12))


def test_allocator_guards():
    a = tkv.PageAllocator(num_pages=4)
    pages = a.allocate(3)
    assert pages == [1, 2, 3] and a.allocate(1) is None
    a.free(pages)
    assert a.free_pages == 3
    with pytest.raises(ValueError, match="double free"):
        a.free([pages[0]])
    with pytest.raises(ValueError, match="reserved"):
        a.free([tkv.GARBAGE_PAGE])
    with pytest.raises(ValueError, match="outside"):
        a.free([99])
    with pytest.raises(ValueError, match="reserved"):
        a.share([tkv.GARBAGE_PAGE])
    assert tkv.pages_needed(5, 4) == jkv.pages_needed(5, 4) == 2


def test_decode_write_matches_jax_inactive_hits_garbage():
    rng = np.random.RandomState(1)
    kp = rng.randn(6, 4, 2, 8).astype(np.float32)
    vp = kp + 1
    k_new = rng.randn(4, 2, 8).astype(np.float32)
    v_new = rng.randn(4, 2, 8).astype(np.float32)
    pt = np.asarray([[2, 3], [4, 99], [5, 1], [3, 2]], np.int32)  # 99: clamped
    pos = np.asarray([1, 6, 3, 0], np.int32)
    active = np.asarray([True, True, False, True])
    jk, jv = jkv.write_decode_kv(*[jnp.asarray(a) for a in (kp, vp, k_new, v_new, pt, pos, active)])
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = tkv.write_decode_kv(tk, tv, *[torch.from_numpy(a) for a in (k_new, v_new, pt, pos, active)])
    assert out[0] is tk and out[1] is tv, "the pools are written in place"
    np.testing.assert_array_equal(tk[1:].numpy(), np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv[1:].numpy(), np.asarray(jv)[1:])
    np.testing.assert_array_equal(tk[5, 3].numpy(), kp[5, 3]), "inactive row wrote a live page"


@pytest.mark.parametrize("prompt_len,start", [(5, 0), (7, 0), (7, 3), (1, 0)])
def test_prompt_write_matches_jax(prompt_len, start):
    rng = np.random.RandomState(2)
    kp = rng.randn(2, 6, 4, 1, 8).astype(np.float32)
    ks = rng.randn(2, 8, 1, 8).astype(np.float32)
    vs = ks * 2
    row = np.asarray([2, 3, 5], np.int32)
    jk, jv = jkv.write_prompt_kv(jnp.asarray(kp), jnp.asarray(kp), jnp.asarray(ks),
                                 jnp.asarray(vs), jnp.asarray(row), jnp.int32(prompt_len),
                                 start=jnp.int32(start))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(kp.copy())
    tkv.write_prompt_kv(tk, tv, torch.from_numpy(ks), torch.from_numpy(vs),
                        torch.from_numpy(row), prompt_len, start=start)
    np.testing.assert_array_equal(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:])


def test_copy_page_matches_jax():
    rng = np.random.RandomState(3)
    pools = {"k": rng.randn(2, 5, 4, 1, 8).astype(np.float32),
             "v": rng.randn(2, 5, 4, 1, 8).astype(np.float32)}
    j = jkv.copy_page({n: jnp.asarray(a) for n, a in pools.items()}, 2, 4)
    t = tkv.copy_page({n: torch.from_numpy(a.copy()) for n, a in pools.items()}, 2, 4)
    for n in ("k", "v"):
        np.testing.assert_array_equal(t[n].numpy(), np.asarray(j[n]))
    with pytest.raises(ValueError, match="outside"):
        tkv.copy_page(t, 0, 3)


def test_alloc_pools_shape_dtype_on_cpu():
    cfg = tkv.KVCacheConfig(num_pages=7, page_size=4, pages_per_seq=3)
    pools = tkv.alloc_pools(2, 3, 16, cfg, device="cpu")
    assert pools["k"].shape == (2, 7, 4, 3, 16) and pools["v"].dtype == torch.bfloat16
    assert float(pools["k"].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="garbage"):
        tkv.KVCacheConfig(num_pages=1)
