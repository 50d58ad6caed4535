"""Pipeline stage-to-stage communication (counterpart of
:mod:`apex_tpu.transformer.pipeline_parallel.p2p_communication`).

Reference: ``apex/transformer/pipeline_parallel/p2p_communication.py``
— ``_communicate`` (:168) with ``batch_isend_irecv``, shape handshakes
and the send/recv wrappers (:385-690).  The JAX package shifts a whole
ring at once with ``ppermute``; here each rank sends and receives its own
tensors, as the reference does: ``torch.distributed`` point-to-point ops
over the pipeline group (NCCL on CUDA, gloo on the CPU).

- :func:`_communicate` posts one exchange over the pipeline group: a
  send to the next stage, a receive from the previous one, a send to the
  previous one and a receive from the next one, each present or not, in
  that order on every rank, as one ``batch_isend_irecv`` (one NCCL
  group), so neighbours that send to each other cannot deadlock.
- One group carries both directions.  NCCL (and gloo) match a pair's
  messages in the order they were posted; at pp 2 a stage's previous and
  next stage are one rank, so the fixed order above is what keeps each
  activation on the activation buffer and each cotangent on the
  cotangent buffer (``tests/test_torch_pipeline_parallel.py`` checks
  that every schedule posts the same sequence on both sides of a pair).
  Two communicators used at once would not be safe: NCCL gives no
  progress guarantee to kernels of different communicators that the
  ranks launch in different orders.  On torch 2.11 with the group
  started eagerly (``device_id``), a batched exchange (of one op or
  more) runs on the group's one communicator, as its collectives do
  (a probe on four H100s counted one communicator a group).
- Shapes and dtypes are static (``(S or S / tp, B / M, H)`` and the
  compute dtype, known from the config), so no handshake is needed.
- The ring wraps: the last stage's next is the first (the interleaved
  schedule's hop from one model chunk to the next).

The wrappers return the received tensors (None where nothing is
received) and take the pipeline group of ``parallel_state`` by default.
"""


import torch

__all__ = ["recv_forward", "recv_backward", "send_forward", "send_backward",
           "send_forward_recv_backward", "send_backward_recv_forward",
           "send_forward_recv_forward", "send_backward_recv_backward",
           "send_forward_backward_recv_forward_backward"]


def _group(group=None):
    """``group`` (an ``AxisGroup``), or the registered pipeline group."""
    if group is not None:
        return group
    from apex_tpu_torch.transformer import parallel_state

    return parallel_state.get_pipeline_model_parallel_group()


def exchange_ops(me: int, n: int, send_next: bool, recv_prev: bool, send_prev: bool,
                 recv_next: bool):
    """The ``(op, peer, what)`` of one exchange on rank ``me`` of ``n``, in
    the order :func:`_communicate` posts them: ``op`` "send" or "recv",
    ``what`` "act" (to next / from previous) or "grad"."""
    nxt, prv = (me + 1) % n, (me - 1) % n
    return ([("send", nxt, "act")] if send_next else []) + \
        ([("recv", prv, "act")] if recv_prev else []) + \
        ([("send", prv, "grad")] if send_prev else []) + \
        ([("recv", nxt, "grad")] if recv_next else [])


def _communicate(tensor_send_next, tensor_send_prev, recv_prev: bool, recv_next: bool,
                 tensor_shape, dtype, device, group=None):
    """One exchange with the neighbours (reference :168): sends
    ``tensor_send_next`` to the next stage and ``tensor_send_prev`` to the
    previous one (either may be None), receives from the previous stage
    when ``recv_prev`` and from the next when ``recv_next``.  Returns
    ``(tensor_recv_prev, tensor_recv_next)``, None where nothing was
    received."""
    import torch.distributed as dist

    g = _group(group)
    n = g.size()
    if n == 1:
        if tensor_send_next is not None or tensor_send_prev is not None or recv_prev or \
                recv_next:
            raise RuntimeError("a pipeline of one stage has no neighbour to talk to")
        return None, None
    recv_p = torch.empty(tuple(tensor_shape), dtype=dtype, device=device) if recv_prev else None
    recv_n = torch.empty(tuple(tensor_shape), dtype=dtype, device=device) if recv_next else None
    tensors = {("send", "act"): tensor_send_next, ("recv", "act"): recv_p,
               ("send", "grad"): tensor_send_prev, ("recv", "grad"): recv_n}
    ops = [dist.P2POp(dist.isend if op == "send" else dist.irecv,
                      tensors[op, what].contiguous() if op == "send" else tensors[op, what],
                      g.ranks[peer], g.group)
           for op, peer, what in exchange_ops(g.rank(), n, tensor_send_next is not None,
                                              recv_prev, tensor_send_prev is not None,
                                              recv_next)]
    for w in dist.batch_isend_irecv(ops) if ops else []:
        w.wait()
    return recv_p, recv_n


def recv_forward(tensor_shape, dtype, device, group=None):
    """The previous stage's activation (reference :385)."""
    return _communicate(None, None, True, False, tensor_shape, dtype, device, group)[0]


def recv_backward(tensor_shape, dtype, device, group=None):
    """The next stage's cotangent (reference :410)."""
    return _communicate(None, None, False, True, tensor_shape, dtype, device, group)[1]


def send_forward(output_tensor, group=None):
    """This stage's activation to the next stage (reference :437)."""
    _communicate(output_tensor, None, False, False, output_tensor.shape, output_tensor.dtype,
                 output_tensor.device, group)


def send_backward(input_tensor_grad, group=None):
    """This stage's input cotangent to the previous stage (reference :463)."""
    _communicate(None, input_tensor_grad, False, False, input_tensor_grad.shape,
                 input_tensor_grad.dtype, input_tensor_grad.device, group)


def send_forward_recv_backward(output_tensor, group=None):
    """The 1F1B steady-state exchange (reference :490): the activation
    forward, the next stage's cotangent back, as one exchange."""
    return _communicate(output_tensor, None, False, True, output_tensor.shape,
                        output_tensor.dtype, output_tensor.device, group)[1]


def send_backward_recv_forward(input_tensor_grad, group=None):
    """The mirror of :func:`send_forward_recv_backward` (reference :521)."""
    return _communicate(None, input_tensor_grad, True, False, input_tensor_grad.shape,
                        input_tensor_grad.dtype, input_tensor_grad.device, group)[0]


def send_forward_recv_forward(output_tensor, recv_prev: bool, tensor_shape, dtype, device,
                              group=None):
    """Send ``output_tensor`` (or nothing) forward and receive the previous
    stage's activation when ``recv_prev`` (reference :552)."""
    return _communicate(output_tensor, None, recv_prev, False, tensor_shape, dtype, device,
                        group)[0]


def send_backward_recv_backward(input_tensor_grad, recv_next: bool, tensor_shape, dtype,
                                device, group=None):
    """Send ``input_tensor_grad`` (or nothing) back and receive the next
    stage's cotangent when ``recv_next`` (reference :582)."""
    return _communicate(None, input_tensor_grad, False, recv_next, tensor_shape, dtype, device,
                        group)[1]


def send_forward_backward_recv_forward_backward(output_tensor, input_tensor_grad,
                                                recv_prev: bool, recv_next: bool, tensor_shape,
                                                dtype, device, group=None):
    """Both directions in one exchange (reference :612): returns
    ``(input_tensor, output_tensor_grad)``."""
    return _communicate(output_tensor, input_tensor_grad, recv_prev, recv_next, tensor_shape,
                        dtype, device, group)
