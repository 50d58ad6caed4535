"""Microbatch calculators (counterpart of
:mod:`apex_tpu.transformer.microbatches`, a copy: pure bookkeeping, no
framework).

Reference: ``apex/transformer/microbatches.py`` —
``build_num_microbatches_calculator`` (:26),
``ConstantNumMicroBatches`` (:93), ``RampupBatchsizeNumMicroBatches``
(:112).  Pure bookkeeping; behavior preserved exactly.
"""

from typing import List, Optional


def build_num_microbatches_calculator(
    rank: int,
    rampup_batch_size: Optional[List[int]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
):
    if rampup_batch_size is None:
        calculator = ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size
        )
        if rank == 0:
            pass  # reference logs here
    else:
        if len(rampup_batch_size) != 3:
            raise ValueError(
                "expected the following format: --rampup-batch-size <start batch size> "
                "<batch size increment> <ramp-up samples>"
            )
        start, incr, samples = map(int, rampup_batch_size)
        calculator = RampupBatchsizeNumMicroBatches(
            start, incr, samples, global_batch_size, micro_batch_size, data_parallel_size
        )
    return calculator


class NumMicroBatchesCalculator:
    def __init__(self):
        self.num_micro_batches = None
        self.current_global_batch_size = None

    def get(self):
        return self.num_micro_batches

    def get_current_global_batch_size(self):
        return self.current_global_batch_size

    def update(self, consumed_samples, consistency_check):
        pass


class ConstantNumMicroBatches(NumMicroBatchesCalculator):
    def __init__(self, global_batch_size, micro_batch_size, data_parallel_size):
        super().__init__()
        micro_batch_times_dp = micro_batch_size * data_parallel_size
        if global_batch_size % micro_batch_times_dp != 0:
            raise ValueError(
                f"global batch size ({global_batch_size}) is not divisible by "
                f"micro batch size ({micro_batch_size}) times data parallel size "
                f"({data_parallel_size})"
            )
        self.num_micro_batches = global_batch_size // micro_batch_times_dp
        assert self.num_micro_batches >= 1
        self.current_global_batch_size = global_batch_size


class RampupBatchsizeNumMicroBatches(NumMicroBatchesCalculator):
    """Linear batch-size rampup (reference :112-178)."""

    def __init__(
        self,
        start_batch_size,
        batch_size_increment,
        ramup_samples,
        global_batch_size,
        micro_batch_size,
        data_parallel_size,
    ):
        super().__init__()
        self.micro_batch_size = micro_batch_size
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = micro_batch_size * data_parallel_size
        assert self.micro_batch_times_data_parallel_size > 0

        assert start_batch_size > 0
        self.start_batch_size = start_batch_size
        assert global_batch_size > 0
        self.global_batch_size = global_batch_size
        diff_batch_size = self.global_batch_size - self.start_batch_size
        assert diff_batch_size >= 0
        assert batch_size_increment > 0
        self.batch_size_increment = batch_size_increment
        assert diff_batch_size % batch_size_increment == 0, (
            "expected global batch size interval ({}) to be divisible by global batch "
            "size increment ({})".format(diff_batch_size, batch_size_increment)
        )

        num_increments = diff_batch_size // self.batch_size_increment
        self.ramup_samples = ramup_samples
        assert self.ramup_samples >= 0
        self.rampup_samples_per_increment = self.ramup_samples / num_increments

        self.update(0, False)

    def update(self, consumed_samples, consistency_check):
        if consumed_samples > self.ramup_samples:
            self.current_global_batch_size = self.global_batch_size
        else:
            steps = int(consumed_samples / self.rampup_samples_per_increment)
            self.current_global_batch_size = (
                self.start_batch_size + steps * self.batch_size_increment
            )
            assert self.current_global_batch_size <= self.global_batch_size
        if consistency_check:
            assert (
                self.current_global_batch_size
                % self.micro_batch_times_data_parallel_size
                == 0
            ), (
                "current global batch size ({}) is not divisible by micro-batch-size "
                "({}) times data parallel size ({})".format(
                    self.current_global_batch_size,
                    self.micro_batch_size,
                    self.data_parallel_size,
                )
            )
        self.num_micro_batches = (
            self.current_global_batch_size // self.micro_batch_times_data_parallel_size
        )
