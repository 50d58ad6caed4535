"""The port's host I/O runtime (``apex_tpu_torch.io`` and the Megatron
samplers) against the JAX package's, on the CPU.

- checkpoints: a file the JAX package's ``save_checkpoint`` wrote loads
  in the port bitwise (fp32, bf16, integer and scalar leaves, a
  NamedTuple state, None subtrees); a file the port wrote passes the JAX
  package's ``validate_checkpoint`` and ``probe_checkpoint`` and holds
  the same header leaves and blob bytes as the JAX package's file of the
  same tree; torn, corrupt and all-torn files raise as the reference's
  do (same exception types, same messages);
- the host library's ``flatten``, ``unflatten`` and ``gather_rows``
  equal numpy;
- both samplers yield the reference's index lists from any
  ``consumed_samples``;
- the async checkpointer snapshots before ``save`` returns, writes in
  order, records each write and re-raises write failures; the prefetch
  iterator keeps order and re-raises its worker's error.
"""

import os
import struct
import threading
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from apex_tpu.io import checkpoint as jckpt
from apex_tpu.optimizers.fused_adam import AdamState as JaxAdamState
from apex_tpu.transformer._data import (
    MegatronPretrainingRandomSampler as JaxRandomSampler,
    MegatronPretrainingSampler as JaxSampler,
)

from apex_tpu_torch import io
from apex_tpu_torch.io import native
from apex_tpu_torch.optimizers.fused_adam import AdamState
from apex_tpu_torch.transformer._data import (
    MegatronPretrainingRandomSampler,
    MegatronPretrainingSampler,
)


def _numpy_tree(seed=0, bf16=True):
    """A driver-shaped tree of numpy leaves (fp32 params and moments, an
    int32 step, an int64 step count, the scaler's Python scalars)."""
    rng = np.random.RandomState(seed)
    params = {"embed": rng.randn(8, 4).astype(np.float32),
              "layers": {"w": rng.randn(2, 4, 4).astype(np.float32),
                         "b": rng.randn(2, 4).astype(np.float32)}}
    if bf16:
        params["head"] = rng.randn(4, 3).astype(np.float32)
    return {
        "params": params,
        "state": {"step": np.int32(3),
                  "exp_avg": {k: v for k, v in params.items()},
                  "exp_avg_sq": params},
        "step": np.int64(3),
        "scaler": {"loss_scale": 4096.0, "growth_tracker": 2, "hysteresis": 1},
    }


def _jax_tree(t, bf16=True):
    """The JAX trainer's tree: jnp leaves, ``AdamState`` for the state,
    the "head" leaf in bf16."""
    def conv(path_key, v):
        a = jnp.asarray(v)
        return a.astype(jnp.bfloat16) if (bf16 and path_key == "head") else a

    params = {k: (conv(k, v) if not isinstance(v, dict) else
                  {kk: conv(kk, vv) for kk, vv in v.items()}) for k, v in t["params"].items()}
    st = t["state"]
    return {"params": params,
            "state": JaxAdamState(step=jnp.asarray(st["step"]),
                                  exp_avg=params, exp_avg_sq=params, master=None),
            "step": t["step"], "scaler": dict(t["scaler"])}


def _port_tree(t, bf16=True):
    def conv(k, v):
        x = torch.from_numpy(np.array(v))
        return x.to(torch.bfloat16) if (bf16 and k == "head") else x

    params = {k: (conv(k, v) if not isinstance(v, dict) else
                  {kk: conv(kk, vv) for kk, vv in v.items()}) for k, v in t["params"].items()}
    return {"params": params,
            "state": AdamState(step=torch.tensor(int(t["state"]["step"]), dtype=torch.int32),
                               exp_avg=params, exp_avg_sq=params, master=None),
            "step": t["step"], "scaler": dict(t["scaler"])}


def _bits(x):
    """A leaf's raw bytes as numpy (bf16 as its 16-bit words)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    a = np.asarray(x)
    return a.view(np.uint16).tobytes() if a.dtype.name == "bfloat16" else a.tobytes()


def _blob(path):
    data = Path(path).read_bytes()
    hlen, tlen = struct.unpack("<QQ", data[8:24])
    return data[24 + hlen + tlen:]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "with_bf16"])
def test_jax_checkpoint_loads_in_port_bitwise(tmp_path, bf16):
    t = _numpy_tree(bf16=bf16)
    jtree = _jax_tree(t, bf16)
    path = tmp_path / "step_00000003.ckpt"
    jckpt.save_checkpoint(path, jtree)
    template = _port_tree(t, bf16)
    got = io.load_checkpoint(path, template=template)
    assert isinstance(got["state"], AdamState) and got["scaler"].keys() == t["scaler"].keys()
    import jax

    want = jax.tree_util.tree_leaves(jtree)
    from apex_tpu_torch.optimizers.tree import tree_leaves

    leaves = tree_leaves(got)
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        assert _bits(g) == _bits(w)
    if bf16:
        assert got["params"]["head"].dtype == torch.bfloat16
    # the lazy reader gives the same bytes, leaf by leaf
    lazy = tree_leaves(io.open_checkpoint_lazy(path, template=template))
    assert [_bits(x.load()) for x in lazy] == [_bits(x) for x in leaves]
    # a JAX file's structure is a jax PyTreeDef: no template, no load
    with pytest.raises(ValueError, match="pass template="):
        io.load_checkpoint(path)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "with_bf16"])
def test_port_checkpoint_passes_jax_validation_and_matches_bytes(tmp_path, bf16):
    t = _numpy_tree(seed=1, bf16=bf16)
    ours, theirs = tmp_path / "step_00000003.ckpt", tmp_path / "jax.ckpt"
    io.save_checkpoint(ours, _port_tree(t, bf16))
    jckpt.save_checkpoint(theirs, _jax_tree(t, bf16))
    h_ours = jckpt.validate_checkpoint(ours)
    assert jckpt.probe_checkpoint(ours)["crc32"] == h_ours["crc32"]
    h_theirs = jckpt.validate_checkpoint(theirs)
    assert h_ours["leaves"] == h_theirs["leaves"]
    assert h_ours["crc32"] == h_theirs["crc32"]
    assert _blob(ours) == _blob(theirs)
    # and the port reads its own file back without a template
    back = io.load_checkpoint(ours)
    assert type(back["state"]).__name__ == "AdamState"
    assert back["state"].master is None
    assert {k: v.item() for k, v in back["scaler"].items()} == t["scaler"]
    assert torch.equal(back["params"]["embed"], torch.from_numpy(t["params"]["embed"]))
    assert io.validate_checkpoint(theirs)["leaves"] == h_theirs["leaves"]


def test_structure_pickle_is_plain_data(tmp_path):
    """The port's structure field unpickles with no class at all."""
    import pickle

    path = tmp_path / "a.ckpt"
    io.save_checkpoint(path, {"x": [torch.zeros(2), (np.int32(1), None)],
                              "s": AdamState(torch.zeros((), dtype=torch.int32), {}, {})})
    data = path.read_bytes()
    hlen, tlen = struct.unpack("<QQ", data[8:24])

    class NoClasses(pickle.Unpickler):
        def find_class(self, module, name):
            raise AssertionError(f"{module}.{name}")

    import io as stdio

    structure = NoClasses(stdio.BytesIO(data[24 + hlen:24 + hlen + tlen])).load()
    assert "dict" in structure
    back = io.load_checkpoint(path)
    assert isinstance(back["x"], list) and isinstance(back["x"][1], tuple)
    assert back["x"][1][1] is None and back["s"].exp_avg == {}


def _torn(path):
    data = path.read_bytes()
    path.write_bytes(data[:-7])


def _flip(path):
    data = bytearray(path.read_bytes())
    data[-3] ^= 0x40
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("damage,match", [(_torn, "is torn"), (_flip, "is corrupt")],
                         ids=["torn", "corrupt"])
def test_damaged_files_raise_as_the_reference(tmp_path, damage, match):
    t = _numpy_tree(seed=2)
    ours, theirs = tmp_path / "ours.ckpt", tmp_path / "theirs.ckpt"
    io.save_checkpoint(ours, _port_tree(t))
    jckpt.save_checkpoint(theirs, _jax_tree(t))
    damage(ours)
    damage(theirs)
    for path in (ours, theirs):
        with pytest.raises(ValueError, match=match) as port_err:
            io.load_checkpoint(path, template=_port_tree(t))
        with pytest.raises(ValueError, match=match) as jax_err:
            jckpt.load_checkpoint(path) if path == theirs else jckpt.probe_checkpoint(path)
        assert str(port_err.value).split(":")[0] == str(jax_err.value).split(":")[0]
    if damage is _torn:
        for path in (ours, theirs):
            with pytest.raises(ValueError, match="is torn"):
                io.validate_checkpoint(path)
    else:
        # size-preserving: validate passes, the deep probe catches it
        io.validate_checkpoint(ours)
        with pytest.raises(ValueError, match="is corrupt"):
            io.probe_checkpoint(ours)


def test_latest_checkpoint_skips_torn_and_raises_when_all_torn(tmp_path):
    t = _port_tree(_numpy_tree(seed=3))
    with pytest.raises(FileNotFoundError):
        io.latest_checkpoint(tmp_path / "missing")
    with pytest.raises(FileNotFoundError) as err:
        io.latest_checkpoint(tmp_path)
    assert not isinstance(err.value, io.AllCheckpointsTornError)
    for s in (2, 4, 6):
        io.save_checkpoint(tmp_path / f"step_{s:08d}.ckpt", t)
    (tmp_path / "step_00000008.ckpt.tmp").write_bytes(b"partial")
    assert io.latest_checkpoint(tmp_path).endswith("step_00000006.ckpt")
    _torn(tmp_path / "step_00000006.ckpt")
    assert io.latest_checkpoint(tmp_path).endswith("step_00000004.ckpt")
    assert jckpt.latest_checkpoint(tmp_path).endswith("step_00000004.ckpt")
    _torn(tmp_path / "step_00000004.ckpt")
    _torn(tmp_path / "step_00000002.ckpt")
    with pytest.raises(io.AllCheckpointsTornError, match="all 3 candidate"):
        io.latest_checkpoint(tmp_path)
    with pytest.raises(jckpt.AllCheckpointsTornError, match="all 3 candidate"):
        jckpt.latest_checkpoint(tmp_path)
    assert io.checkpoint_step("step_00000042.ckpt") == 42 == jckpt.checkpoint_step(
        "step_00000042.ckpt")


def test_probe_dir_and_quarantine(tmp_path):
    t = _port_tree(_numpy_tree(seed=4))
    for s in (1, 2):
        io.save_checkpoint(tmp_path / f"step_{s:08d}.ckpt", t)
    assert io.probe_checkpoint_dir(tmp_path) is None
    _flip(tmp_path / "step_00000002.ckpt")
    bad = io.probe_checkpoint_dir(tmp_path)
    assert bad is not None and bad.path.endswith("step_00000002.ckpt")
    assert "corrupt" in bad.reason
    want = jckpt.probe_checkpoint_dir(tmp_path)
    assert (want.path, want.reason) == (bad.path, bad.reason)
    dest = io.quarantine_checkpoint(tmp_path, bad.path, bad.reason)
    assert Path(dest).exists() and (tmp_path / "quarantine" / "step_00000002.ckpt.reason.json").exists()
    assert io.latest_checkpoint(tmp_path).endswith("step_00000001.ckpt")
    assert io.probe_checkpoint_dir(tmp_path) is None


# ------------------------------------------------------------ host library
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8, np.int64],
                         ids=lambda d: np.dtype(d).name)
def test_flatten_unflatten_equal_numpy(dtype):
    rng = np.random.RandomState(5)
    shapes = [(3, 5), (), (0,), (7,), (2, 2, 2)]
    arrays = [np.asarray(rng.randn(*s) * 100).astype(dtype) for s in shapes]
    blob = native.flatten(arrays, threads=3)
    want = np.concatenate([a.reshape(-1).view(np.uint8) for a in arrays])
    assert blob.dtype == np.uint8 and np.array_equal(blob, want)
    back = native.unflatten(blob, shapes, [dtype] * len(shapes), threads=3)
    for a, b in zip(arrays, back):
        assert b.shape == a.shape and np.array_equal(a, b)
    with pytest.raises(ValueError, match="buffer holds"):
        native.unflatten(blob[:-1], shapes, [dtype] * len(shapes))


@pytest.mark.parametrize("dtype", [np.uint16, np.int32], ids=["uint16", "int32"])
def test_gather_rows_equal_numpy(dtype):
    rng = np.random.RandomState(6)
    src = rng.randint(0, 50000, size=(37, 65)).astype(dtype)
    idx = rng.randint(0, 37, size=19)
    assert np.array_equal(native.gather_rows(src, idx, threads=4), src[idx])
    # a memmapped source, as the trainer's --data corpus
    assert np.array_equal(native.gather_rows(src[5:20], [0, 14, 3]), src[5:20][[0, 14, 3]])
    with pytest.raises(IndexError):
        native.gather_rows(src, [37])


# ---------------------------------------------------------------- samplers
@pytest.mark.parametrize("consumed", [0, 8, 24, 40, 56])
@pytest.mark.parametrize("dp", [(0, 1), (1, 2), (3, 4)], ids=["dp1", "r1of2", "r3of4"])
def test_samplers_match_reference(consumed, dp):
    rank, size = dp
    kw = dict(total_samples=64, consumed_samples=consumed, micro_batch_size=2,
              data_parallel_rank=rank, data_parallel_size=size)
    assert list(MegatronPretrainingSampler(**kw)) == list(JaxSampler(**kw))
    assert list(MegatronPretrainingSampler(**kw, drop_last=False)) == list(
        JaxSampler(**kw, drop_last=False))
    if consumed % (2 * size) == 0:
        rk = dict(kw, total_samples=67)
        assert list(MegatronPretrainingRandomSampler(**rk)) == list(JaxRandomSampler(**rk))
        rk = dict(rk, consumed_samples=consumed + 67 - 67 % (2 * size))  # next epoch
        assert list(MegatronPretrainingRandomSampler(**rk)) == list(JaxRandomSampler(**rk))


def test_sampler_refuses_what_the_reference_refuses():
    for kw in (dict(total_samples=0, consumed_samples=0), dict(total_samples=8,
                                                            consumed_samples=8)):
        with pytest.raises(ValueError):
            MegatronPretrainingSampler(**kw, micro_batch_size=2, data_parallel_rank=0,
                                       data_parallel_size=1)
        with pytest.raises(ValueError):
            JaxSampler(**kw, micro_batch_size=2, data_parallel_rank=0, data_parallel_size=1)


# ------------------------------------------------------ async + prefetch
def test_async_checkpointer_snapshots_before_save_returns(tmp_path):
    p = {"w": torch.arange(6, dtype=torch.float32)}
    with io.AsyncCheckpointer() as ck:
        ck.save(tmp_path / "step_00000001.ckpt", {"params": p, "step": np.int64(1)})
        p["w"].add_(100.0)  # what the next in-place step does
        ck.save(tmp_path / "step_00000002.ckpt", {"params": p, "step": np.int64(2)})
        ck.wait_until_finished()
        assert [Path(w["path"]).name for w in ck.writes] == ["step_00000001.ckpt",
                                                             "step_00000002.ckpt"]
        assert all(w["bytes"] == os.path.getsize(w["path"]) and w["seconds"] >= 0
                   for w in ck.writes)
    one = io.load_checkpoint(tmp_path / "step_00000001.ckpt")
    two = io.load_checkpoint(tmp_path / "step_00000002.ckpt")
    assert torch.equal(one["params"]["w"], torch.arange(6, dtype=torch.float32))
    assert torch.equal(two["params"]["w"], torch.arange(6, dtype=torch.float32) + 100)
    assert int(two["step"]) == 2


def test_async_checkpointer_reraises_write_failures(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    ck = io.AsyncCheckpointer()
    ck.save(blocker / "step_00000001.ckpt", {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ck.wait_until_finished()
    ck.save(tmp_path / "ok.ckpt", {"a": torch.zeros(2)})  # still usable
    ck.close()
    assert (tmp_path / "ok.ckpt").exists()
    with pytest.raises(RuntimeError, match="closed"):
        ck.save(tmp_path / "late.ckpt", {})


def test_async_checkpointer_in_flight_lists_pending_saves(tmp_path, monkeypatch):
    from apex_tpu_torch.io import async_checkpoint

    gate, real = threading.Event(), async_checkpoint.save_checkpoint
    monkeypatch.setattr(async_checkpoint, "save_checkpoint",
                        lambda path, tree: (gate.wait(10), real(path, tree)))
    ck = io.AsyncCheckpointer()
    paths = [str(tmp_path / f"step_{k:08d}.ckpt") for k in (1, 2, 3)]
    for k, path in enumerate(paths):
        ck.save(path, {"a": torch.full((2,), float(k))})
    assert ck.in_flight() == paths  # one on the writer, two queued
    gate.set()
    ck.wait_until_finished()
    assert ck.in_flight() == [] and all(os.path.exists(p) for p in paths)
    (tmp_path / "file").write_text("x")
    ck.save(tmp_path / "file" / "x.ckpt", {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ck.wait_until_finished()
    assert ck.in_flight() == []  # a failed write leaves the list too
    ck.close()


def test_prefetch_keeps_order_and_reraises():
    it = io.PrefetchIterator(iter(range(10)), size=2, transform=lambda x: x * x)
    assert list(it) == [x * x for x in range(10)]

    def bad():
        yield 1
        raise KeyError("worker")

    it = io.PrefetchIterator(bad(), size=1)
    assert next(it) == 1
    with pytest.raises(KeyError, match="worker"):
        next(it)


def test_namedtuple_without_template_rebuilds_fields(tmp_path):
    Pair = namedtuple("Pair", ["a", "b"])
    io.save_checkpoint(tmp_path / "p.ckpt", {"p": Pair(torch.ones(2), None)})
    back = io.load_checkpoint(tmp_path / "p.ckpt")["p"]
    assert back._fields == ("a", "b") and back.b is None and torch.equal(back.a, torch.ones(2))
