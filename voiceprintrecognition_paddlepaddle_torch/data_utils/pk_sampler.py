"""P×K batch sampler: each batch holds ``batch_size / sample_per_id``
random classes with ``sample_per_id`` samples each (a copy of the JAX
package's ``data_utils/pk_sampler.py``: the same seeds give the same
batches).

Semantics of reference ``ppvector/data_utils/pk_sampler.py:8-59``
(required by TripletAngularMarginLoss) plus the rank/num_replicas sharding
that the reference gets from paddle's DistributedBatchSampler: each process
draws from its own epoch+rank-seeded RNG and yields ``len(dataset) //
(batch_size * num_replicas)`` batches.
"""

from collections import defaultdict

import numpy as np

__all__ = ["PKSampler", "BatchSampler"]


class PKSampler:
    def __init__(self, dataset, batch_size, sample_per_id, shuffle=True,
                 drop_last=True, num_replicas=1, rank=0, seed=1000):
        assert batch_size % sample_per_id == 0, \
            f"batch_size({batch_size}) must be a multiple of sample_per_id"
        self.batch_size = batch_size
        self.sample_per_id = sample_per_id
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0
        self.label_dict = defaultdict(list)
        for idx, label in enumerate(dataset.labels):
            self.label_dict[int(label)].append(idx)
        self.label_list = list(self.label_dict)
        assert len(self.label_list) * sample_per_id >= batch_size, \
            "not enough classes for a full P×K batch"
        self._num_batches = len(dataset.labels) // (batch_size * num_replicas)

    def __len__(self):
        return self._num_batches

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        # One (seed, epoch)-keyed stream executed identically on every
        # rank; per step, the classes for ALL replicas are drawn jointly
        # without replacement, so replica batches are disjoint within a
        # step (distinct classes ⇒ distinct items), and epoch streams never
        # collide (the old rank*max(epoch,1)+epoch seed collided — e.g.
        # rank 0/epoch 2 replayed rank 1/epoch 1).
        rng = np.random.RandomState((self.seed + self.epoch) % (2 ** 31))
        label_per_batch = self.batch_size // self.sample_per_id
        need = label_per_batch * self.num_replicas
        for _ in range(self._num_batches):
            if len(self.label_list) >= need:
                chosen_all = rng.choice(len(self.label_list), size=need,
                                        replace=False)
            else:  # too few classes for fully disjoint replicas
                chosen_all = np.concatenate(
                    [rng.choice(len(self.label_list), size=label_per_batch,
                                replace=False)
                     for _ in range(self.num_replicas)])
            for r in range(self.num_replicas):
                chosen = chosen_all[r * label_per_batch:
                                    (r + 1) * label_per_batch]
                batch = []
                for li in chosen:
                    pool = self.label_dict[self.label_list[li]]
                    batch.extend(rng.choice(
                        pool, size=self.sample_per_id,
                        replace=len(pool) < self.sample_per_id))
                if self.shuffle:
                    rng.shuffle(batch)
                if r == self.rank:
                    yield [int(i) for i in batch]
        self.epoch += 1


class BatchSampler:
    """Plain (optionally sharded) batch sampler — the default path
    (reference ``trainer.py:99,105-107``)."""

    def __init__(self, dataset, batch_size, shuffle=True, drop_last=True,
                 num_replicas=1, rank=0, seed=1000):
        self.n = len(dataset)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        per_rank = self.n // self.num_replicas
        if self.drop_last:
            # training: every rank must step the same number of times
            # (the train step is collective), so floor to the common size
            return per_rank // self.batch_size
        # eval (drop_last=False): idx[rank::num_replicas] gives low ranks
        # ceil(n/world) items — cover the WHOLE shard, else the trailing
        # utterances are silently never embedded and EER is computed over
        # an incomplete trial set (shard sizes may differ by one batch;
        # allgather_ragged handles the unevenness)
        mine = per_rank + (1 if self.rank < self.n % self.num_replicas
                           else 0)
        return (mine + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        idx = idx[self.rank::self.num_replicas]
        nb = len(self)
        for i in range(nb):
            batch = idx[i * self.batch_size:(i + 1) * self.batch_size]
            if len(batch) == 0:
                break
            yield [int(j) for j in batch]
        self.epoch += 1
