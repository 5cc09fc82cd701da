"""Streamed word count over files, on one device.

Counterpart of the result contract of :mod:`mapreduce_tpu.runtime.executor`
(``count_file``, ``recover_from_file``, ``absolute_offsets``) in its
unpipelined form: the reader's batches fold through the one-device
:class:`...parallel.mapreduce.Engine` in order.  The JAX executor's pipeline
(prefetch, in-flight groups), checkpoints, ledger and retries are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mapreduce_tpu_torch.config import DEFAULT_CONFIG, Config
from mapreduce_tpu_torch.data import reader as reader_mod
from mapreduce_tpu_torch.models.wordcount import (WordCountJob,
                                                  WordCountResult,
                                                  _reported_distinct,
                                                  apply_top_k)
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.parallel.mapreduce import Engine


def absolute_offsets(chunk_id: np.ndarray, pos: np.ndarray,
                     bases: np.ndarray, n_devices: int) -> np.ndarray:
    """Decode (chunk_id = step * n_devices + device, in-chunk pos) into
    absolute corpus offsets via the recorded row bases."""
    step, dev = chunk_id // n_devices, chunk_id % n_devices
    return bases[step, dev] + pos


def recover_from_file(tbl: table_ops.CountTable, path, bases: np.ndarray,
                      n_devices: int = 1,
                      estimate_distinct: bool = True) -> WordCountResult:
    """Host-side string recovery for a streamed run, words in file order of
    first occurrence."""
    count = tbl.count.cpu().numpy()
    count_hi = tbl.count_hi.cpu().numpy()
    valid = (count > 0) | (count_hi > 0)
    chunk_id = tbl.pos_hi.cpu().numpy()[valid]
    pos = tbl.pos_lo.cpu().numpy()[valid]
    length = tbl.length.cpu().numpy()[valid]
    cnt = (count + (count_hi << 32))[valid]
    absolute = absolute_offsets(chunk_id, pos, bases, n_devices)
    order = np.argsort(absolute, kind="stable")
    spans = [(int(absolute[i]), int(length[i])) for i in order]
    words = reader_mod.read_words_at_multi(path, spans)
    dropped_uniques, dropped_count = tbl.dropped_totals()
    return WordCountResult(
        words=words,
        counts=[int(c) for c in cnt[order]],
        total=tbl.total_count(),
        distinct=_reported_distinct(tbl, len(words), dropped_uniques,
                                    estimate_distinct),
        dropped_uniques=dropped_uniques,
        dropped_count=dropped_count,
    )


def count_file(path, config: Config = DEFAULT_CONFIG, device=None,
               top_k: int | None = None) -> WordCountResult:
    """WordCount over one file or a list of files (one corpus), streamed in
    ``config.chunk_bytes`` chunks.  ``device`` defaults to the card.

    ``top_k`` keeps the k most frequent words, as the JAX package's top-k
    job does: the table's KMV distinct estimate is taken before the
    terminal top-k reorder, and evicted entries fold into ``dropped_*``.
    """
    job = WordCountJob(config, device)
    engine = Engine(job, job.device)
    state = engine.init_states()
    bases = []
    for batch in reader_mod.iter_batches_multi(path, 1, config.chunk_bytes):
        state = engine.step(state, batch.data, batch.step)
        bases.append(batch.base_offsets)
    tbl = engine.finish(state)
    bases_arr = np.stack(bases) if bases else np.zeros((0, 1), np.int64)
    kmv_est = None
    if top_k:
        n_valid, kth_hi, kth_lo = (int(x) for x in table_ops.kmv_snapshot(tbl))
        kmv_est = table_ops.kmv_from_snapshot(n_valid, kth_hi, kth_lo,
                                              config.table_capacity)
        tbl = table_ops.top_k(tbl, top_k)
    result = recover_from_file(tbl, path, bases_arr, 1,
                               estimate_distinct=not top_k)
    if kmv_est is not None:
        result = dataclasses.replace(
            result, distinct=max(len(result.words), int(round(kmv_est))))
    if top_k:
        result = apply_top_k(result, top_k)
    return result
