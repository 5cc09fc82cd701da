"""Uniform token sampling: a bottom-k sketch as a MapReduce job.

Counterpart of :mod:`mapreduce_tpu.models.sample`.  Every
token occurrence gets a pseudo-uniform 64-bit priority (a hash of its
global identity: chunk id and byte offset), and the sample is the k
smallest.  Bottom-k of a union is the bottom-k of the parts' bottom-k's:

* map     = tokenize + hash priorities + select the k smallest;
* combine = concat ``[2k]`` + sort + slice ``[:k]``, tiny and fixed-size;
* merge   = the same op, associative and commutative.

The result is a uniform k-sample without replacement over token
occurrences; strings are recovered host-side from (chunk id, pos, len).

Maps.  On the ``xla`` backend the map runs the plain per-byte tokenizer.
On the kernel backend it launches the tokenize kernel once a chunk in pair
mode (``tokenize_split``, counted as ``tokenize_pair``) and reads nothing
back: the kernel's dense stream has unwritten rows past its device-side
live count, which are masked off on the device.  Tokens longer than W are
excluded from both the sample and the population (the stream's ``total``
counts only tokens of W bytes or fewer), as in the JAX package.

Selection.  The JAX map sorts every row by ``(prio_hi, prio_lo, packed)``
and keeps k.  Here two ``torch.topk`` passes select the same rows: the k
smallest 64-bit priorities give the k-th value v; then every row below v
and the rows at v with the smallest tie-break (``packed``, or the position
on the plain path) make the k, sorted by the same keys.  Exact, ties at
the k-th place included, with no host read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mapreduce_tpu_torch import constants
from mapreduce_tpu_torch.config import DEFAULT_CONFIG, Config
from mapreduce_tpu_torch.ops import datastats
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.ops.cuda import tokenize as kernel_tok
from mapreduce_tpu_torch.ops.table import _key64, _lexsort
from mapreduce_tpu_torch.runtime.platform import resolve_device

MASK32 = 0xFFFFFFFF
_MAXU = 0xFFFFFFFF
#: Above every tie-break value (they are uint32).
_TIE_INF = 1 << 40


class ReservoirState(NamedTuple):
    """Bottom-k sample: ``[k]`` int64 tensors holding uint32, and the
    population as a 64-bit (lo, hi) pair of scalars."""

    prio_hi: torch.Tensor  # priority high word (all-ones = empty slot)
    prio_lo: torch.Tensor  # priority low word
    pos_hi: torch.Tensor  # chunk id of the sampled occurrence
    pos_lo: torch.Tensor  # byte offset within the chunk
    length: torch.Tensor  # token length in bytes
    total_lo: torch.Tensor  # population size seen, low word
    total_hi: torch.Tensor


def _empty(k: int, device) -> ReservoirState:
    full = torch.full((k,), _MAXU, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return ReservoirState(full, full.clone(), full.clone(), full.clone(),
                          torch.zeros((k,), dtype=torch.int64, device=device),
                          zero, zero.clone())


def _bottom_k(state_parts, k: int) -> tuple:
    """Sort by 64-bit priority, then position (the JAX 4-key sort), and
    keep the k smallest; ``length`` rides along."""
    prio_hi, prio_lo, pos_hi, pos_lo, length = state_parts
    order = _lexsort(_key64(prio_hi, prio_lo), _key64(pos_hi, pos_lo))[:k]
    return tuple(x[order] for x in state_parts)


def _select_k(key: torch.Tensor, tie: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first ``min(k, n)`` rows in ``(key, tie)`` order, in
    that order: what a full 2-key sort sliced to k gives (rows equal in
    both keys are interchangeable).  ``tie`` holds uint32 values."""
    kk = min(k, key.shape[0])
    v = torch.topk(key, kk, largest=False, sorted=False).values.max()
    # Every row below v is in; the rest of the k come from the rows at v,
    # smallest tie-break first.
    sec = torch.where(key < v, -1, torch.where(key == v, tie, _TIE_INF))
    cand = torch.topk(sec, kk, largest=False, sorted=False).indices
    return cand[_lexsort(key[cand], tie[cand])]


class ReservoirSampleJob:
    """Uniform bottom-k token sampling as a MapReduce job."""

    def __init__(self, k: int, config: Config = DEFAULT_CONFIG, device=None):
        if k < 1:
            raise ValueError(f"sample size must be >= 1, got {k}")
        self.k = k
        self.config = config
        self.device = resolve_device(device)

    def init_state(self) -> ReservoirState:
        return _empty(self.k, self.device)

    @staticmethod
    def _priorities(pos: torch.Tensor, is_tok: torch.Tensor, chunk_id):
        """Two pseudo-uniform priority lanes from the occurrence's global
        identity (chunk id, byte offset), the JAX package's hash: both
        backends see the same (chunk id, pos) pairs for any token of W
        bytes or fewer, so they draw the same sample."""
        cid = int(chunk_id) & MASK32
        seed1 = tok_ops.mul32(pos, int(constants.HASH_BASE_1)) \
            ^ tok_ops._fmix32((cid + 0x9E3779B9) & MASK32)
        seed2 = tok_ops.mul32(pos, int(constants.HASH_BASE_2)) \
            ^ tok_ops._fmix32(cid ^ 0x85EBCA6B)
        prio_hi = tok_ops._fmix32(seed1)
        # Clamp off the all-ones empty-slot sentinel (2**-32 per token).
        prio_hi = torch.where(prio_hi == _MAXU, _MAXU - 1, prio_hi)
        prio_hi = torch.where(is_tok, prio_hi, _MAXU)
        prio_lo = torch.where(is_tok, tok_ops._fmix32(seed2), _MAXU)
        return prio_hi, prio_lo

    def map_chunk(self, chunk: torch.Tensor, chunk_id) -> ReservoirState:
        if self.config.resolved_backend() == "pallas":
            return self._map_chunk_kernel(chunk, chunk_id)
        stream = tok_ops.tokenize(chunk)
        is_tok = stream.count > 0
        prio_hi, prio_lo = self._priorities(stream.pos, is_tok, chunk_id)
        pos_hi = torch.where(is_tok, int(chunk_id) & MASK32, _MAXU)
        sel = _select_k(_key64(prio_hi, prio_lo), stream.pos, self.k)
        parts = tuple(x[sel] for x in (prio_hi, prio_lo, pos_hi, stream.pos,
                                       stream.length))
        return ReservoirState(*parts, is_tok.sum(),
                              torch.zeros((), dtype=torch.int64,
                                          device=chunk.device))

    def _map_chunk_kernel(self, chunk: torch.Tensor,
                          chunk_id) -> ReservoirState:
        """The kernel map: one pair-mode ``tokenize_stream`` launch, the
        priorities from the packed rows, and the k smallest by (priority,
        packed), the JAX kernel map's 3-key order.  No host read: rows
        past the stream's live count are masked on the device."""
        stream, _ = kernel_tok.tokenize_split(
            chunk, max_token_bytes=self.config.pallas_max_token)
        packed = stream.packed
        rows = torch.arange(packed.shape[0], device=packed.device)
        # Poison rows (zero length bits), the dead row and the unwritten
        # rows after it are not samples.
        is_tok = (rows < stream.live) & (packed != _MAXU) \
            & ((packed & 63) != 0)
        prio_hi, prio_lo = self._priorities(packed >> 6, is_tok, chunk_id)
        packed = torch.where(is_tok, packed, _MAXU)
        sel = _select_k(_key64(prio_hi, prio_lo), packed, self.k)
        prio_hi, prio_lo, packed = prio_hi[sel], prio_lo[sel], packed[sel]
        live = prio_hi != _MAXU
        return ReservoirState(
            prio_hi=prio_hi, prio_lo=prio_lo,
            pos_hi=torch.where(live, int(chunk_id) & MASK32, _MAXU),
            pos_lo=torch.where(live, packed >> 6, _MAXU),
            length=torch.where(live, packed & 63, 0),
            total_lo=stream.total,
            total_hi=torch.zeros((), dtype=torch.int64, device=chunk.device))

    def map_chunk_stats(self, chunk: torch.Tensor, chunk_id, axis=None,
                        device_index: int = 0):
        """Stats-mode map: the reservoir has no spill or rescue machinery,
        so the chunk counters are the chunk itself; :meth:`state_stats`
        fills the gauges."""
        return self.map_chunk(chunk, chunk_id), datastats.map_stats()

    def state_stats(self, state: ReservoirState, stats):
        """Gauges: the population as ``tokens``, the live reservoir slots
        as ``table_valid`` (the reservoir is this family's table)."""
        return stats._replace(
            table_valid=(state.prio_hi != _MAXU).sum(),
            tokens=state.total_lo + (state.total_hi << 32))

    def combine(self, state: ReservoirState,
                update: ReservoirState) -> ReservoirState:
        parts = _bottom_k(tuple(torch.cat((a, b)) for a, b in
                                zip(state[:5], update[:5])), self.k)
        lo = state.total_lo + update.total_lo
        hi = (state.total_hi + update.total_hi + (lo >> 32)) & MASK32
        return ReservoirState(*parts, lo & MASK32, hi)

    def merge(self, a: ReservoirState, b: ReservoirState) -> ReservoirState:
        return self.combine(a, b)

    def finalize(self, state: ReservoirState) -> ReservoirState:
        return state

    def identity(self) -> str:
        return f"sample{self.k}"


class SampleResult(NamedTuple):
    """Host-side result: sampled token occurrences + population size."""

    tokens: list
    total: int  # population size the sample was drawn from


def _host_sample(st: ReservoirState):
    """The live slots in priority order: (pos_hi, pos_lo, length) numpy
    arrays, and the population."""
    prio_hi, pos_hi, pos_lo, length = (
        x.cpu().numpy() for x in (st.prio_hi, st.pos_hi, st.pos_lo,
                                  st.length))
    live = prio_hi != _MAXU
    return (pos_hi[live], pos_lo[live], length[live],
            int(st.total_lo) + (int(st.total_hi) << 32))


def sample_bytes(data: bytes, k: int, config: Config = DEFAULT_CONFIG,
                 device=None) -> SampleResult:
    """One-call API: uniform k-sample of token occurrences in a buffer."""
    from mapreduce_tpu_torch.models.wordcount import _pad_for_backend

    job = ReservoirSampleJob(k, config, device)
    chunk = torch.from_numpy(_pad_for_backend(data, config)).to(job.device)
    _, pos, length, total = _host_sample(job.map_chunk(chunk, 0))
    # Ascending priority = unbiased order; positions are direct.
    return SampleResult([bytes(data[int(o): int(o) + int(n)])
                         for o, n in zip(pos, length)], total)


def sample_file(path, k: int, config: Config = DEFAULT_CONFIG, device=None,
                **kw) -> SampleResult:
    """Uniform k-sample over a file (or a list of files, one corpus)
    through the streamed executor, tokens in priority order; ``kw`` goes
    to ``run_job``.  Across ranks the coordinator recovers the tokens and
    returns the result; the other ranks return None."""
    from mapreduce_tpu_torch.data import reader
    from mapreduce_tpu_torch.runtime import executor

    rr = executor.run_job(ReservoirSampleJob(k, config, device), path,
                          config, **kw)
    if rr.rank != 0:
        return None
    chunk_id, pos, length, total = _host_sample(rr.value)
    absolute = executor.absolute_offsets(chunk_id, pos, rr.bases,
                                         rr.bases.shape[1])
    return SampleResult(reader.read_words_at_multi(path, absolute, length),
                        total)
