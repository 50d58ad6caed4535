"""What the card's NCCL does for the ZeRO engine, on a one-rank group.

    python -m apex_tpu_torch.nccl_probe        # on one card; prints one JSON line

- which dtypes ``reduce_scatter_tensor`` and ``all_reduce`` take (fp32,
  bf16, int8, uint8, float8_e4m3fn, float8_e5m2) and whether an
  ``all_to_all_single`` of bytes runs: the quantized wire's choices
  (:mod:`apex_tpu_torch.contrib.optimizers._quantized_sync`);
- whether a reduce-scatter, an all-gather and a MAX all-reduce captured
  in a CUDA graph (after an eager warm-up on the capturing side stream,
  as :class:`apex_tpu_torch.graphs.CapturedStep` runs them) replay with
  the right values on new inputs;
- the same for the overlapped step's pattern
  (``train_gpt.overlap_value_and_grads``): a second stream forked from
  the capturing one by an event, an asynchronous reduce-scatter started
  there, more work queued on the capturing stream, the wait and a read
  of the result on the second stream, and the join before the capturing
  stream reads it;
- the device ms (CUDA events over 10 calls) of a reduce-scatter, an
  all-gather and a plain copy of GPT-124M's 124,475,904 fp32 elements:
  at world 1 NCCL copies.

NCCL's version, the card and ``nvidia-smi``'s name and power limit are
printed beside the numbers.
"""

import json
import subprocess
import sys

import torch


def _events_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe(n=124_475_904):
    import torch.distributed as dist

    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.parallel.distributed import all_gather_flat, reduce_scatter_flat

    dev = multiproc.initialize_distributed("cuda")
    out = {"nccl": ".".join(map(str, torch.cuda.nccl.version())),
           "device": torch.cuda.get_device_name(dev),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True, timeout=60).stdout.strip()}
    try:
        x = torch.arange(16, device=dev, dtype=torch.float32)
        for dt in (torch.float32, torch.bfloat16, torch.int8, torch.uint8,
                   torch.float8_e4m3fn, torch.float8_e5m2):
            name = str(dt).replace("torch.", "")
            for op in ("reduce_scatter", "all_reduce"):
                try:
                    a = x.to(dt)
                    if op == "reduce_scatter":
                        got = torch.empty_like(a)
                        reduce_scatter_flat(got, a, None)
                    else:
                        got = a.clone()
                        dist.all_reduce(got)
                    torch.cuda.synchronize()
                    out[f"{op}_{name}"] = bool((got.float() == a.float()).all())
                except Exception as e:  # noqa: BLE001 -- the refusal is the finding
                    out[f"{op}_{name}"] = repr(e)[:200]
        a = x.to(torch.uint8)
        got = torch.empty_like(a)
        dist.all_to_all_single(got, a)
        torch.cuda.synchronize()
        out["all_to_all_uint8"] = bool((got == a).all())

        side = torch.cuda.Stream(dev)
        buf = torch.ones(1 << 20, device=dev)
        shard, full = torch.empty_like(buf), torch.empty_like(buf)

        def body():
            reduce_scatter_flat(shard, buf * 2, None)
            all_gather_flat(full, shard + 1, None)
            m = torch.ones(1, device=dev)
            dist.all_reduce(m, op=dist.ReduceOp.MAX)
            return full.sum() + m[0]

        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            result = body()
        buf.fill_(3)
        graph.replay()
        torch.cuda.synchronize()
        out["captured_replay"] = float(result)
        out["captured_replay_expected"] = float((3 * 2 + 1) * (1 << 20) + 1)

        comm = torch.cuda.Stream(dev)
        grads = torch.ones(1 << 20, device=dev)
        later, got = torch.empty_like(grads), torch.empty_like(grads)

        def overlapped():
            main = torch.cuda.current_stream(dev)
            g = grads * 3  # the stage's backward, on the capturing stream
            comm.wait_stream(main)
            with torch.cuda.stream(comm):
                shard = torch.empty_like(g)
                work = reduce_scatter_flat(shard, g, None, async_op=True)
            later.copy_(g * 2)  # the next stage's backward meanwhile
            with torch.cuda.stream(comm):
                work.wait()
                synced = shard + 1
            main.wait_stream(comm)
            got.copy_(synced)
            return got.sum() + later.sum()

        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            overlapped()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph2 = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph2, stream=side):
            result2 = overlapped()
        grads.fill_(5)
        graph2.replay()
        torch.cuda.synchronize()
        out["captured_async_replay"] = float(result2)
        out["captured_async_replay_expected"] = float((5 * 3 + 1 + 5 * 3 * 2) * (1 << 20))

        a = torch.randn(n, device=dev)
        o = torch.empty_like(a)
        out["elements"] = n
        out["reduce_scatter_ms"] = _events_ms(lambda: reduce_scatter_flat(o, a, None))
        out["all_gather_ms"] = _events_ms(lambda: all_gather_flat(o, a, None))
        out["copy_ms"] = _events_ms(lambda: o.copy_(a))
    finally:
        multiproc.destroy_distributed()
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("nccl_probe: no CUDA device")
    print(json.dumps(probe()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
