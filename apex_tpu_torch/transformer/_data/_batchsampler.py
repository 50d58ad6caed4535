"""Megatron pretraining batch samplers (counterpart of
:mod:`apex_tpu.transformer._data._batchsampler`).

Reference: ``apex/transformer/_data/_batchsampler.py`` —
``MegatronPretrainingSampler`` (:38, sequential, DP-sharded slice per
rank) and ``MegatronPretrainingRandomSampler`` (:96, epoch-seeded
shuffle of full-batch buckets).  Framework-independent index logic, so
the behavior carries over verbatim; yields lists of dataset indices for
this data-parallel rank.
"""

from typing import Iterator, List

import numpy as np


class MegatronPretrainingSampler:
    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        micro_batch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
        drop_last: bool = True,
    ):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.micro_batch_times_data_parallel_size = micro_batch_size * data_parallel_size
        self.drop_last = drop_last

        if self.total_samples <= 0:
            raise ValueError(f"dataset is empty (total_samples={self.total_samples})")
        if self.consumed_samples >= self.total_samples:
            raise ValueError(
                f"every sample already consumed ({self.consumed_samples} of {self.total_samples})"
            )
        assert self.micro_batch_size > 0
        assert data_parallel_size > 0
        if self.data_parallel_rank >= data_parallel_size:
            raise ValueError(
                f"dp rank {self.data_parallel_rank} out of range for dp world {data_parallel_size}"
            )

    def __len__(self):
        return self.total_samples

    def get_start_end_idx(self):
        start_idx = self.data_parallel_rank * self.micro_batch_size
        end_idx = start_idx + self.micro_batch_size
        return start_idx, end_idx

    def __iter__(self) -> Iterator[List[int]]:
        batch = []
        # Last batch will be dropped if drop_last is not set False
        for idx in range(self.consumed_samples, self.total_samples):
            batch.append(idx)
            if len(batch) == self.micro_batch_times_data_parallel_size:
                start_idx, end_idx = self.get_start_end_idx()
                yield batch[start_idx:end_idx]
                batch = []
        # Check the last partial batch and see drop_last is set
        if len(batch) > 0 and not self.drop_last:
            start_idx, end_idx = self.get_start_end_idx()
            yield batch[start_idx:end_idx]


class MegatronPretrainingRandomSampler:
    def __init__(
        self,
        total_samples: int,
        consumed_samples: int,
        micro_batch_size: int,
        data_parallel_rank: int,
        data_parallel_size: int,
    ):
        self.total_samples = total_samples
        self.consumed_samples = consumed_samples
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = micro_batch_size * data_parallel_size
        self.last_batch_size = self.total_samples % self.micro_batch_times_data_parallel_size

        assert self.total_samples > 0
        assert self.micro_batch_size > 0
        assert data_parallel_size > 0
        assert self.data_parallel_rank < data_parallel_size

    def __len__(self):
        return self.total_samples

    def __iter__(self) -> Iterator[List[int]]:
        active_total_samples = self.total_samples - self.last_batch_size
        self.epoch = self.consumed_samples // active_total_samples
        current_epoch_samples = self.consumed_samples % active_total_samples
        assert current_epoch_samples % self.micro_batch_times_data_parallel_size == 0

        # data sharding and random sampling
        bucket_size = (
            self.total_samples // self.micro_batch_times_data_parallel_size
        ) * self.micro_batch_size
        bucket_offset = current_epoch_samples // self.data_parallel_size
        start_idx = self.data_parallel_rank * bucket_size

        g = np.random.RandomState(self.epoch)
        random_idx = g.permutation(bucket_size).tolist()
        idx_range = [start_idx + x for x in random_idx[bucket_offset:]]

        batch = []
        for idx in idx_range:
            batch.append(idx)
            if len(batch) == self.micro_batch_size:
                self.consumed_samples += self.micro_batch_times_data_parallel_size
                yield batch
                batch = []
