"""The port's tensor-parallel decoding (``gpt_forward(return_kv=True)``
and ``forward_decode(axis_name=)`` under a tp group) against the JAX
package, on the CPU.

Mirrors ``tests/test_inference.py``'s ``test_tp2_decode_matches_dense_
training``: a world of 2 ranks under gloo (``parallel.multiproc.launch``)
prefills 8 positions through ``gpt_forward(return_kv=True)`` on each
rank's shard (the rank's kv heads), writes them into the rank's pools
(its ``kv_heads / tp`` heads: the JAX ``pool_spec`` splits that dim
over tp), and decodes the next position with ``forward_decode``:
vocab-parallel embedding, column-parallel q, k, v on the local heads,
paged decode attention on the local pools, row-parallel wo and fc2, the
final LayerNorm and the copy-to-region.  The fp32 logits of the rank's
vocab shard, gathered, are held against the JAX dense training forward
at the JAX test's band (atol 5e-6), against the JAX tp 2 ``shard_map``
decode and against the port's own tp 1 decode (both 5e-6), for MHA with
rope, GQA (2 kv heads: one a rank), learned positions, and a verify
width of 3 (three positions of one sequence in one call).  Each rank's
captured k/v are the head slice of the tp 1 capture (1e-6).
"""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.inference import KVCacheConfig as JaxKVCacheConfig
from apex_tpu.inference import alloc_pools as jax_alloc_pools
from apex_tpu.inference import write_prompt_kv as jax_write_prompt_kv
from apex_tpu.models import gpt as jgpt

from apex_tpu_torch.inference import KVCacheConfig, alloc_pools, write_prompt_kv
from apex_tpu_torch.models import gpt as tgpt
from apex_tpu_torch.parallel import multiproc

REPO = Path(__file__).resolve().parent.parent
#: tests/test_inference.py's tp 2 decode band (fp32 logits, absolute)
ATOL = 5e-6
#: the captured k/v against the tp 1 capture's head slice
KV_ATOL = 1e-6
#: tests/test_inference.py's tiny_cfg at vocab 64
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_attention_heads=4, max_seq_len=64,
            position_embedding_type="rope", checkpoint_layers=False)
#: name -> (config overrides, verify width)
CASES = {"mha": ({}, 1), "gqa": ({"num_query_groups": 2}, 1),
         "learned": ({"position_embedding_type": "learned"}, 1), "width3": ({}, 3)}
S = 8
NEXT = (5, 17, 40)
KV = dict(num_pages=6, page_size=4, pages_per_seq=3)
ROW = (1, 2, 3)


def jax_params(name):
    cfg = jgpt.GPTConfig(**{**TINY, **CASES[name][0]}, compute_dtype=jnp.float32)
    return cfg, jgpt.init_params(cfg, jax.random.PRNGKey(0))


def tokens(width):
    rng = np.random.RandomState(1)
    return np.concatenate([rng.randint(0, 64, size=(1, S)),
                           np.asarray([NEXT[:width]])], axis=1)


def decode_inputs(width, lib):
    """tokens, positions, active and the page table of one decode call of
    ``width`` rows (positions S .. S + width - 1 of one sequence)."""
    full = tokens(width)
    return (lib.asarray(full[0, S:S + width]), lib.asarray(np.arange(S, S + width)),
            lib.asarray(np.ones(width, bool)), lib.asarray(np.asarray([ROW], np.int32)))


CHILD = r'''
import sys, pickle
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from apex_tpu_torch.parallel import initialize_distributed, destroy_distributed
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import all_gather_dim
from apex_tpu_torch.models import gpt
from apex_tpu_torch.inference import KVCacheConfig, alloc_pools, write_prompt_kv
trees, CASES, TINY, S, KV, ROW, toks = pickle.load(open(sys.argv[3], "rb"))
initialize_distributed("cpu")
ps.initialize_model_parallel(tensor_model_parallel_size_=2)
g = ps.get_tensor_model_parallel_group()
out = {}
for name, (over, width) in CASES.items():
    cfg = gpt.GPTConfig(**{**TINY, **over}, compute_dtype=torch.float32)
    p = gpt.shard_params(trees[name], cfg, g, "cpu")
    full = torch.from_numpy(toks[width])
    with torch.no_grad():
        _, (k, v) = gpt.gpt_forward(p, full[:, :S], cfg, return_hidden=True, return_kv=True,
                                    axis_name=g)
        pools = alloc_pools(cfg.num_layers, cfg.kv_heads // 2, cfg.head_dim,
                            KVCacheConfig(**KV, dtype=torch.float32), device="cpu")
        row = torch.tensor(ROW, dtype=torch.int32)
        write_prompt_kv(pools["k"], pools["v"], k[:, 0].transpose(1, 2), v[:, 0].transpose(1, 2),
                        row, S)
        h, _ = gpt.forward_decode(p, full[0, S:S + width], torch.arange(S, S + width),
                                  torch.ones(width, dtype=torch.bool), pools, row[None], cfg,
                                  verify_width=width, axis_name=g)
        logits = torch.matmul(h.float(), p["embed"].float().T)
        out[name] = (all_gather_dim(logits, g, -1), k, v)
torch.save(out, sys.argv[2] + f"/rank{dist.get_rank()}.pt")
destroy_distributed()
'''


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_decode")
    trees = {name: jax.tree.map(np.asarray, jax_params(name)[1]) for name in CASES}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((trees, CASES, TINY, S, KV, ROW, {w: tokens(w) for w in (1, 3)}), f)
    multiproc.launch(["-c", CHILD, str(REPO), str(d), str(d / "in.pkl")], 2, timeout=300)
    return [torch.load(d / f"rank{r}.pt") for r in range(2)]


def _jax_tp2(name, devices):
    """The JAX test's tp 2 ``shard_map`` decode (prefill through
    ``gpt_forward(return_kv=True)`` on the shard, ``forward_decode`` on
    the local pools), fp32 logits over the whole vocab."""
    cfg, params = jax_params(name)
    width = CASES[name][1]
    full = jnp.asarray(tokens(width))
    mesh = Mesh(np.array(devices[:2]).reshape(2, 1), ("tp", "dp"))
    pool_spec = P(None, None, None, "tp", None)
    kcfg = JaxKVCacheConfig(**KV, dtype=jnp.float32)
    pools = jax_alloc_pools(cfg.num_layers, cfg.kv_heads, cfg.head_dim, kcfg)
    toks, pos, active, pt = decode_inputs(width, jnp)

    def local(params, kpool, vpool, toks, pos, active, pt):
        _, kv = jgpt.gpt_forward(params, full[:, :S], cfg, axis_name="tp", return_hidden=True,
                                 return_kv=True)
        ks = kv[0][:, 0].transpose(0, 2, 1, 3)
        vs = kv[1][:, 0].transpose(0, 2, 1, 3)
        kpool, vpool = jax_write_prompt_kv(kpool, vpool, ks, vs, pt[0], jnp.int32(S))
        h, _ = jgpt.forward_decode(params, toks, pos, active, {"k": kpool, "v": vpool}, pt, cfg,
                                   axis_name="tp", attn_impl="xla", verify_width=width)
        return jnp.matmul(h.astype(jnp.float32), params["embed"].T.astype(jnp.float32))

    fn = jax.jit(jax.shard_map(local, mesh=mesh,
                               in_specs=(jgpt.param_specs(cfg), pool_spec, pool_spec, P(), P(),
                                         P(), P()),
                               out_specs=P(None, "tp"), check_vma=False))
    return np.asarray(fn(params, pools["k"], pools["v"], toks, pos, active, pt))


def _port_tp1(name):
    """The port's decode with no group, from the same params: logits and
    the prefill's k/v."""
    over, width = CASES[name]
    cfg = tgpt.GPTConfig(**{**TINY, **over}, compute_dtype=torch.float32)
    p = tgpt.params_from_numpy(jax.tree.map(np.asarray, jax_params(name)[1]), cfg, "cpu")
    full = torch.from_numpy(tokens(width))
    with torch.no_grad():
        _, (k, v) = tgpt.gpt_forward(p, full[:, :S], cfg, return_kv=True)
        pools = alloc_pools(cfg.num_layers, cfg.kv_heads, cfg.head_dim,
                            KVCacheConfig(**KV, dtype=torch.float32), device="cpu")
        row = torch.tensor(ROW, dtype=torch.int32)
        write_prompt_kv(pools["k"], pools["v"], k[:, 0].transpose(1, 2), v[:, 0].transpose(1, 2),
                        row, S)
        toks, pos, active, pt = (torch.as_tensor(a) for a in decode_inputs(width, np))
        h, _ = tgpt.forward_decode(p, toks, pos, active, pools, pt, cfg, verify_width=width)
    return torch.matmul(h, p["embed"].T).numpy(), k, v


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp2_decode_matches_dense_training(world2, devices8, name):
    """Every rank's gathered tp 2 logits against the JAX dense training
    forward at the decoded positions (atol 5e-6, the JAX test's band),
    the JAX tp 2 decode and the port's tp 1 decode (5e-6)."""
    cfg, params = jax_params(name)
    width = CASES[name][1]
    dense = np.asarray(jgpt.gpt_forward(params, jnp.asarray(tokens(width)), cfg))[S:, 0]
    jax_tp2 = _jax_tp2(name, devices8)
    tp1 = _port_tp1(name)[0]
    for res in world2:
        got = res[name][0].numpy()
        assert got.shape == dense.shape == (width, 64)
        np.testing.assert_allclose(got, dense, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, jax_tp2, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, tp1, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_tp2_prefill_kv_is_the_local_heads(world2, name):
    """``gpt_forward(return_kv=True)`` under tp 2 returns each rank's
    kv_heads / 2 heads: the rank's slice of the tp 1 capture."""
    _, k1, v1 = _port_tp1(name)
    n = k1.shape[2] // 2
    for rank, res in enumerate(world2):
        _, k, v = res[name]
        assert k.shape[2] == n
        for got, want in ((k, k1), (v, v1)):
            np.testing.assert_allclose(got.numpy(), want[:, :, rank * n:(rank + 1) * n].numpy(),
                                       rtol=0, atol=KV_ATOL)
