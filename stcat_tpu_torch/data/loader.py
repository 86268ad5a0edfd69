"""Data loader: a sample pool and a batch pool feeding fixed-shape batches.

    loader = make_loader(cfg, dataset, "train", start_iter=0)
    for batch, targets, meta in loader: ...     # numpy containers

  * train: an infinite, iteration-counted stream over MAX_EPOCH epochs,
    reshuffled per epoch from SEED + epoch, resumable at ``start_iter``;
  * eval: one pass in order; the last batch is filled by wrapping around to
    the first items, and those rows reuse a real sample's arrays (no second
    decode) and are marked ``meta["pad"]`` so the engine skips them;
  * DATALOADER.ASPECT_RATIO_GROUPING: batches of one orientation, built
    locally along the permutation;
  * each sample draws from its own ``np.random.Generator``, seeded by
    (SEED, iteration, index), so a batch is the same whichever worker builds
    it and whenever the run resumed;
  * DATALOADER.PREFETCH_DEPTH whole batches in flight on a batch pool, each
    fanning its samples out to a pool of DATALOADER.NUM_WORKERS threads;
  * TPU.DEVICE_PREPROCESS (with a dataset that ``supports_raw``): raw
    batches, rgb or yuv420 by TPU.INGEST_LAYOUT, resampled on the card;
    without it the host transforms the pixels and the loader yields
    VideoBatches of normalised float32 frames (``build_batch``).
The world size and rank come from ``core/dist.py``: each rank loads its own
shard of every epoch. The host-to-device copy is ``core/prefetch.py``'s.
"""

from __future__ import annotations

import math
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

from ..core.dist import get_rank, get_world_size
from .batching import build_batch, build_raw_batch, pick_bucket, raw_batch_signature
from .tokenize import build_tokenizer


class Loader:
    def __init__(self, cfg, dataset, global_batch: int, is_train: bool, start_iter: int = 0,
                 shard_index: int = 0, num_shards: int = 1,
                 num_workers: Optional[int] = None, seed: Optional[int] = None):
        self.cfg = cfg
        self.dataset = dataset
        self.raw = bool(cfg.TPU.DEVICE_PREPROCESS) and bool(getattr(dataset, "supports_raw",
                                                                    False))
        if cfg.TPU.INGEST_LAYOUT not in ("rgb", "yuv420"):
            raise ValueError(f"TPU.INGEST_LAYOUT={cfg.TPU.INGEST_LAYOUT!r}: "
                             "expected 'rgb' or 'yuv420'")
        self.global_batch = global_batch
        self.is_train = is_train
        self.start_iter = start_iter
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.seed = cfg.SEED if seed is None else seed
        self.tokenizer = build_tokenizer(cfg)
        self.num_workers = cfg.DATALOADER.NUM_WORKERS if num_workers is None else num_workers
        n = len(dataset)
        self.iters_per_epoch = max(1, math.ceil(n / (global_batch * num_shards)))
        self._epoch_cache: Optional[Tuple[int, np.ndarray, np.ndarray]] = None
        self._orientation: Optional[np.ndarray] = None

    def _epoch_indices(self, epoch: int) -> Tuple[np.ndarray, np.ndarray]:
        """This shard's index stream for one epoch, and its wrap-around mask
        (True = the row repeats an item already covered this epoch).

        Called from the batch-pool threads: the cache is read once, so a
        thread that publishes the next epoch's cache between the check and
        the return cannot hand this epoch's caller the wrong permutation."""
        cache = self._epoch_cache
        if cache is not None and cache[0] == epoch:
            return cache[1], cache[2]
        n = len(self.dataset)
        if self.is_train and self.cfg.SOLVER.SHUFFLE:
            idx = np.random.default_rng(self.seed + epoch).permutation(n)
        else:
            idx = np.arange(n)
        if self.cfg.DATALOADER.ASPECT_RATIO_GROUPING and hasattr(self.dataset, "items"):
            # walk the permutation with one buffer per orientation and emit a
            # global batch whenever a buffer fills; the epoch's leftovers go
            # last, per orientation, in permutation order
            if self._orientation is None:
                items = self.dataset.items
                self._orientation = np.asarray([items[i]["width"] >= items[i]["height"]
                                                for i in range(n)])
            gb = self.global_batch * self.num_shards
            buffers = {True: [], False: []}
            order = []
            for i in idx:
                buf = buffers[bool(self._orientation[i])]
                buf.append(i)
                if len(buf) == gb:
                    order.extend(buf)
                    buf.clear()
            order.extend(buffers[True])
            order.extend(buffers[False])
            idx = np.asarray(order, dtype=idx.dtype)
        # fill every shard x batch slot by wrapping around, then take this shard
        total = self.iters_per_epoch * self.global_batch * self.num_shards
        pad = np.arange(total) >= n
        idx = np.resize(idx, total)
        shard = idx[self.shard_index:: self.num_shards]
        shard_pad = pad[self.shard_index:: self.num_shards]
        self._epoch_cache = (epoch, shard, shard_pad)
        return shard, shard_pad

    def _load_sample(self, index: int, it: int, plan_only: bool = False):
        rng = np.random.default_rng((self.seed * 1_000_003 + it) % (2**31) + int(index))
        return self.dataset.__getitem__(int(index), rng=rng, raw=self.raw, plan_only=plan_only)

    def _eval_samples(self, rows, rpad, load):
        """An eval batch's samples from load(row), a sample or the Future of
        one: wrap-around rows reuse the batch's first real sample, marked
        ``pad``; a batch of wrap-around rows only loads its first row, to
        fill the shapes."""
        real = [(j, load(r)) for j, r in enumerate(rows) if not rpad[j]]
        if not real:
            real = [(0, load(rows[0]))]
            rpad = np.ones_like(rpad)
        got = {j: s.result() if isinstance(s, Future) else s for j, s in real}
        filler = {**got[real[0][0]], "pad": True}
        return [got[j] if (j in got and not rpad[j]) else filler for j in range(len(rows))]

    def scan_signatures(self, epochs: int = 1) -> Dict[tuple, list]:
        """{signature: exemplar samples} of every batch shape this loader
        emits (``batching.raw_batch_signature``), found without decoding a
        pixel: the iterator's epoch indices and per-(iteration, index)
        generators replayed through plan-only samples. ``_make_batch`` of an
        exemplar builds a batch of that shape. Train scans ``epochs`` epochs
        (the augmentation draws differ per epoch); eval is one pass, its
        wrap-around rows filled as the iterator fills them. Raw batches only:
        the host path's batches are keyed by frame bucket and resolution."""
        if not self.raw:
            raise ValueError(
                "scan_signatures targets the raw (TPU.DEVICE_PREPROCESS) path; host-transform "
                "batches key only on (bucket, resolution)")
        sigs: Dict[tuple, list] = {}
        for epoch in range(epochs if self.is_train else 1):
            indices, pad = self._epoch_indices(epoch)
            for within in range(self.iters_per_epoch):
                it = epoch * self.iters_per_epoch + within
                sl = slice(within * self.global_batch, (within + 1) * self.global_batch)
                if self.is_train:
                    samples = [self._load_sample(r, it, plan_only=True) for r in indices[sl]]
                else:
                    samples = self._eval_samples(
                        indices[sl], pad[sl],
                        lambda r: self._load_sample(r, within, plan_only=True))
                sigs.setdefault(raw_batch_signature(samples, self.cfg.TPU.FRAME_BUCKETS),
                                samples)
        return sigs

    def _make_batch(self, samples):
        t_bucket = pick_bucket(max(len(s["actioness"]) for s in samples),
                               self.cfg.TPU.FRAME_BUCKETS)
        build = build_raw_batch if self.raw else build_batch
        return build(samples, t_bucket, self.tokenizer, self.cfg.INPUT.MAX_QUERY_LEN)

    def __iter__(self):
        return self._train_iter() if self.is_train else self._eval_iter()

    def _pipelined(self, load_batch, first: int, last: int):
        """load_batch(i) for i in [first, last), PREFETCH_DEPTH batches ahead."""
        depth = max(1, self.cfg.DATALOADER.PREFETCH_DEPTH)
        batch_pool = ThreadPoolExecutor(max_workers=depth)
        sample_pool = ThreadPoolExecutor(max_workers=max(1, self.num_workers))
        try:
            window: deque = deque()
            nxt = first
            while nxt < min(first + depth, last):
                window.append(batch_pool.submit(load_batch, nxt, sample_pool))
                nxt += 1
            while window:
                fut = window.popleft()
                if nxt < last:
                    window.append(batch_pool.submit(load_batch, nxt, sample_pool))
                    nxt += 1
                yield fut.result()
        finally:
            batch_pool.shutdown(wait=False, cancel_futures=True)
            sample_pool.shutdown(wait=False, cancel_futures=True)

    def _train_iter(self):
        max_iter = self.cfg.SOLVER.MAX_EPOCH * self.iters_per_epoch

        def load_batch(i, sample_pool):
            epoch, within = divmod(i, self.iters_per_epoch)
            indices, _ = self._epoch_indices(epoch)
            rows = indices[within * self.global_batch:(within + 1) * self.global_batch]
            futs = [sample_pool.submit(self._load_sample, r, i) for r in rows]
            return self._make_batch([f.result() for f in futs])

        return self._pipelined(load_batch, self.start_iter, max_iter)

    def _eval_iter(self):
        indices, pad = self._epoch_indices(0)
        n_batches = len(indices) // self.global_batch

        def load_batch(bi, sample_pool):
            sl = slice(bi * self.global_batch, (bi + 1) * self.global_batch)
            return self._make_batch(self._eval_samples(
                indices[sl], pad[sl], lambda r: sample_pool.submit(self._load_sample, r, bi)))

        return self._pipelined(load_batch, 0, n_batches)


def make_loader(cfg, dataset, mode: str, start_iter: int = 0) -> Loader:
    """SOLVER.BATCH_SIZE clips per rank; each rank loads its own shard."""
    return Loader(cfg, dataset, global_batch=cfg.SOLVER.BATCH_SIZE, is_train=(mode == "train"),
                  start_iter=start_iter, shard_index=get_rank(), num_shards=get_world_size())
