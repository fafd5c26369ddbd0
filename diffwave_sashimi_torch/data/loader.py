"""Batching data loader with epoch shuffling and replica sharding.

Port of ``diffwave_sashimi_tpu/data/loader.py``: a seeded per-epoch
permutation (``RandomState(seed + epoch)``), padded by wrapping to a
multiple of ``num_replicas`` and taken with stride ``num_replicas`` from
``replica_id`` (the reference's DistributedSampler), then ``drop_last``
batches.  An SC09 batch is ``(wavs (B, 1, L) float32, sample_rates (B,),
labels)``; a mel-conditioned dataset (LJSpeech, :class:`.mel2samp.
Mel2Samp`) gives ``(mel (B, 80, frames), audio (B, 1, L))``, its crops
drawn in batch order from the dataset's seeded stream, as in JAX.  Clips
are decoded with scipy in the calling thread (the JAX package's native
decoder and prefetch thread are not ported; a train step at the shipped
size takes far longer than decoding four clips).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np

from .sc09 import SpeechCommands


class DataLoader:
    def __init__(self, dataset, batch_size: int, num_replicas: int = 1,
                 replica_id: int = 0, seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.num_replicas = int(num_replicas)
        self.replica_id = int(replica_id)
        self.seed = seed
        self.epoch = 0

    def _shard_indices(self, epoch: int) -> np.ndarray:
        idx = np.random.RandomState(self.seed + epoch).permutation(
            len(self.dataset))
        pad = (-len(idx)) % self.num_replicas
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        return idx[self.replica_id::self.num_replicas]

    def __len__(self) -> int:
        shard = (len(self.dataset) + self.num_replicas - 1) \
            // self.num_replicas
        return shard // self.batch_size

    def _collate(self, indices: List[int]):
        items = [self.dataset[i] for i in indices]
        if len(items[0]) == 2:               # Mel2Samp's (mel, audio)
            return (np.stack([it[0] for it in items]),
                    np.stack([it[1] for it in items]))
        wavs = np.stack([it[0] for it in items])
        srs = np.asarray([it[1] for it in items])
        return wavs, srs, [it[2] for it in items]

    def __iter__(self) -> Iterator:
        idx = self._shard_indices(self.epoch)
        self.epoch += 1
        bs = self.batch_size
        for s in range(0, (len(idx) // bs) * bs, bs):
            yield self._collate([int(i) for i in idx[s:s + bs]])


def dataloader(dataset_cfg, batch_size: int, num_replicas: int = 1,
               replica_id: int = 0, unconditional: bool = True,
               seed: int = 0) -> DataLoader:
    """The dataset of ``dataset_cfg`` behind a :class:`DataLoader`: SC09
    for an unconditional model or an SC09 config, else :class:`Mel2Samp`
    of the config's keys."""
    cfg = dict(dataset_cfg)
    name = cfg.pop("_name_", "sc09")
    if unconditional or name in ("sc09", "sc", "speechcommands"):
        ds = SpeechCommands(cfg["data_path"],
                            segment_length=cfg.get("segment_length", 16000),
                            sampling_rate=cfg.get("sampling_rate", 16000))
    else:
        # imported here: ``python -m ...data.mel2samp`` imports this package
        # first, and runs mel2samp as __main__ only if it is not loaded yet
        from .mel2samp import Mel2Samp
        ds = Mel2Samp(**cfg)
    return DataLoader(ds, batch_size, num_replicas=num_replicas,
                      replica_id=replica_id, seed=seed)
