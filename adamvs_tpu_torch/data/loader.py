"""Host-side batching iterator with background prefetch (counterpart of
adamvs_tpu/data/loader.py).

The reference feeds the GPU from a single-worker torch DataLoader
(train_whu.py:85-86); here a thread pool decodes and assembles samples ahead
of the card, ``prefetch`` batches deep, and each batch is collated into
numpy arrays. The order, the per-sample ``RandomState((seed + epoch) *
100003 + idx)`` of the augmentation and ``drop_last`` are the JAX loader's,
so a seed and an epoch give the same batches as there.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator

import numpy as np

from .lists import SampleSpec
from .pipeline import TrainSample, batch_train_samples, load_train_sample


def batch_iterator(
    samples: list[SampleSpec],
    batch_size: int,
    mode: str,
    shuffle: bool,
    seed: int = 0,
    num_workers: int = 2,
    interval_scale: float = 1.0,
    drop_last: bool = True,
    epoch: int = 0,
    prefetch: int = 4,
) -> Iterator[dict]:
    """Batches of ``batch_size`` samples in order, or shuffled by
    ``RandomState(seed + epoch)``; a short last batch is dropped when
    ``drop_last``."""
    order = np.arange(len(samples))
    rng = np.random.RandomState(seed + epoch)
    if shuffle:
        rng.shuffle(order)
    n = len(order)
    if drop_last:
        n = (n // batch_size) * batch_size
    order = order[:n]

    def load(idx: int) -> TrainSample:
        worker_rng = np.random.RandomState((seed + epoch) * 100003 + int(idx))
        return load_train_sample(
            samples[int(idx)], mode=mode, interval_scale=interval_scale, rng=worker_rng
        )

    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        futures = []
        starts = list(range(0, n, batch_size))
        for s in starts[: prefetch]:
            futures.append([pool.submit(load, i) for i in order[s : s + batch_size]])
        for bi, s in enumerate(starts):
            nxt = bi + prefetch
            if nxt < len(starts):
                s2 = starts[nxt]
                futures.append([pool.submit(load, i) for i in order[s2 : s2 + batch_size]])
            batch = [f.result() for f in futures[bi]]
            yield batch_train_samples(batch)
