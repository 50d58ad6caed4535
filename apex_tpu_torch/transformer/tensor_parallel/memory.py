"""Contiguous activation buffers (counterpart of
:mod:`apex_tpu.transformer.tensor_parallel.memory`).

Reference: ``apex/transformer/tensor_parallel/memory.py``:
``MemoryBuffer`` (:37), ``RingMemBuffer`` (:138), ``allocate_mem_buff``
(:25): one preallocated flat tensor that activations are copied into at
a bump cursor, so that the allocator does not fragment.  Here it is a
flat tensor again, allocated at the first :meth:`MemoryBuffer.add` on
that tensor's device (or ``device``): ``add`` copies the flattened
tensor in at the cursor and returns that piece as a view of the
tensor's shape; ``reset`` rewinds the cursor.  Usage is sampled at
``get_data``, as in the reference (memory.py:115-120).
"""

from typing import Dict

import torch

__all__ = ["MemoryBuffer", "RingMemBuffer", "allocate_mem_buff", "get_mem_buff",
           "get_mem_buffs", "reset_mem_buffs"]

#: every allocated buffer, by name (memory.py:22 ``_MEM_BUFFS``)
_MEM_BUFFS: Dict[str, "MemoryBuffer"] = {}


def allocate_mem_buff(name: str, numel: int, dtype, track_usage: bool = False, device=None):
    """A named buffer (memory.py:25)."""
    if name in _MEM_BUFFS:
        raise AssertionError(f"memory buffer {name} already allocated.")
    _MEM_BUFFS[name] = MemoryBuffer(name, numel, dtype, track_usage, device)
    return _MEM_BUFFS[name]


def get_mem_buff(name: str):
    """Reference memory.py:32."""
    return _MEM_BUFFS[name]


def get_mem_buffs():
    return dict(_MEM_BUFFS)


def reset_mem_buffs():
    _MEM_BUFFS.clear()


class MemoryBuffer:
    """A bump-allocated flat buffer of ``numel`` elements (memory.py:37)."""

    def __init__(self, name: str, numel: int, dtype, track_usage: bool = False, device=None):
        self.name = name
        self.numel = int(numel)
        self.dtype = dtype
        self.device = device
        self._data = None  # allocated at first use: an unused buffer holds no memory
        self._start = 0
        self.track_usage = track_usage
        self.in_use_value = 0.0
        self.total_value = 0.0

    @property
    def data(self) -> torch.Tensor:
        if self._data is None:
            from apex_tpu_torch._device import resolve_device

            dev = resolve_device(self.device if self.device is not None else "cuda")
            self._data = torch.zeros(self.numel, dtype=self.dtype, device=dev)
        return self._data

    def reset(self):
        """Rewind the cursor; the contents become dead (memory.py:79)."""
        self._start = 0

    def is_in_use(self) -> bool:
        return self._start > 0

    def numel_in_use(self) -> int:
        return self._start

    def add(self, tensor: torch.Tensor) -> torch.Tensor:
        """Copy ``tensor`` in at the cursor; returns the copy as a view of
        the buffer in ``tensor``'s shape (memory.py:91)."""
        if tensor.dtype != self.dtype:
            raise AssertionError(
                f"Input tensor dtype {tensor.dtype} != buffer dtype {self.dtype}")
        n = tensor.numel()
        new_start = self._start + n
        if new_start > self.numel:
            raise AssertionError(f"Not enough memory buffer ({self.name})")
        if self._data is None and self.device is None:
            self.device = tensor.device
        view = self.data[self._start:new_start].view(tensor.shape)
        view.copy_(tensor)
        self._start = new_start
        return view

    def get_data(self) -> torch.Tensor:
        """The live prefix; samples usage (memory.py:115-120)."""
        if self.track_usage:
            self.in_use_value += float(self._start)
            self.total_value += float(self.numel)
        if self._data is None:
            return torch.zeros(0, dtype=self.dtype)
        return self._data[:self._start]

    def print_average_usage(self):
        if not self.track_usage:
            raise AssertionError("You need to enable usage tracking")
        print(f" > usage of {self.name} memory buffer: "
              f"{self.in_use_value * 100.0 / max(self.total_value, 1.0):.2f} %")


class RingMemBuffer:
    """A ring of ``num_buffers`` buffers, the next one handed out reset
    (memory.py:138)."""

    def __init__(self, name: str, num_buffers: int, numel: int, dtype, track_usage=False,
                 device=None):
        self.num_buffers = num_buffers
        self.buffers = [allocate_mem_buff(f"{name} {i}", numel, dtype, track_usage, device)
                        for i in range(num_buffers)]
        self._index = -1

    def get_next_buffer(self):
        self._index = (self._index + 1) % self.num_buffers
        buff = self.buffers[self._index]
        buff.reset()
        return buff
