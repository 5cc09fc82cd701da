"""Distributed grep: count occurrences and matching lines of fixed patterns.

Counterpart of :mod:`mapreduce_tpu.models.grep`.  The state is
a handful of 64-bit scalars (per pattern) instead of a count table, so the
reduction is a plain add.

Map.  For a pattern of m bytes the match mask over a chunk is the AND of m
shifted byte-equality (or byte-class) planes: torch elementwise ops, the
work the JAX package leaves to one fused XLA pass, and no host read.
Matching *lines* reuse the segmented-scan idea with newline as the reset
class.  Torch has no ``associative_scan``, so the JAX package's segmented
prefix-OR (``_or_reset_combine``) becomes one running maximum: with
``seg`` the running count of newlines at or before each position (a
newline opens its own segment, so it resets at its own position), a
position's segment holds a match at or before it iff the running maximum
of ``seg`` over the matched positions equals its own ``seg``.  Patterns
run one at a time within one pass of the chunk, so the live set is one
pattern's planes, not ``[P, chunk]`` tensors.

Envelope (as in the JAX package):

* occurrences are **overlapping** (``aa`` occurs twice in ``aaa``);
* a pattern containing separator bytes never matches across a chunk seam
  (the reader cuts at separators);
* ``lines`` is **exact**, including lines split across chunks: every chunk
  emits a line-boundary summary (has-newline, first and last segment
  matched) and a carry bit in the state threads "the open line has
  matched" from chunk to chunk as the boolean-affine transfer
  ``c' = a | (b & c)``.  The streamed map gathers the summaries of its
  step's D rows over the data axis (one all_gather of 3 words a pattern),
  so each rank composes its incoming carry as the JAX package does;
* counts are 64-bit: uint32 ``lo``/``hi`` lanes with an explicit carry,
  each held in an int64 tensor (the port's uint32 convention).

Records mode (:func:`grep_records`, the port's own; the Pavlo et al.
grep task): one pattern's counts and every matching line, in file order.
The map also emits, a chunk at a time, the positions of the matches that
open their line within the chunk, compacted on the card and copied to the
host behind one declared sync (:func:`_emit`); the host reads the lines
around them from the files after the stream (:func:`recover_records`).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from mapreduce_tpu_torch.config import DEFAULT_CONFIG, Config
from mapreduce_tpu_torch.obs.spans import span
from mapreduce_tpu_torch.ops import datastats
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.ops import tracepoints
from mapreduce_tpu_torch.ops.table import add64
from mapreduce_tpu_torch.runtime.platform import resolve_device

MASK32 = 0xFFFFFFFF


class GrepState(NamedTuple):
    """Running counts (int64 tensors holding uint32; scalars, or ``[P]``
    for a multi-pattern job)."""

    matches_lo: torch.Tensor  # overlapping occurrences, low word
    matches_hi: torch.Tensor  # high word
    lines_lo: torch.Tensor  # lines holding >= 1 occurrence, low word
    lines_hi: torch.Tensor  # high word
    line_carry: Any = 0  # 0/1: the open line has matched so far


class GrepUpdate(NamedTuple):
    """One chunk's contribution and its seam-correction terms.

    ``lines`` assumes the step's incoming line carry is 0; ``delta`` is
    what to subtract if it is 1.  ``blk_a``/``blk_b`` are the whole step's
    composed transfer ``c' = blk_a | (blk_b & c)``."""

    matches_lo: torch.Tensor
    matches_hi: torch.Tensor
    lines: torch.Tensor
    delta: torch.Tensor
    blk_a: torch.Tensor
    blk_b: torch.Tensor


class ClassPattern:
    """Regex-lite pattern: one allowed byte set per position.

    Syntax: plain bytes match themselves; ``.`` matches any byte except
    newline (and the NUL pad); ``[abc]`` / ``[a-z0-9]`` are classes with
    ranges; ``[^...]`` negates (NUL stays excluded so padding can never
    match); ``\\x`` escapes the next byte anywhere.  No repetition or
    alternation: the pattern length is fixed, so the match mask stays one
    elementwise pass with a couple of compares per class range.
    """

    def __init__(self, spec: bytes):
        self.spec = bytes(spec)
        self.classes: list[tuple[bool, tuple[tuple[int, int], ...]]] = []
        i, n = 0, len(self.spec)
        while i < n:
            b = self.spec[i]
            if b == 0x5C:  # backslash escape
                if i + 1 >= n:
                    raise ValueError("grep pattern ends with a dangling '\\'")
                self.classes.append((False, ((self.spec[i + 1],) * 2,)))
                i += 2
            elif b == 0x2E:  # '.': any byte but newline (NUL auto-excluded)
                self.classes.append((True, ((0x0A, 0x0A),)))
                i += 1
            elif b == 0x5B:  # '[' class
                j = i + 1
                negated = j < n and self.spec[j] == 0x5E
                if negated:
                    j += 1
                ranges: list[tuple[int, int]] = []
                while j < n and self.spec[j] != 0x5D:
                    c = self.spec[j]
                    if c == 0x5C and j + 1 < n:
                        j += 1
                        c = self.spec[j]
                    if (j + 2 < n and self.spec[j + 1] == 0x2D
                            and self.spec[j + 2] != 0x5D):
                        hi = self.spec[j + 2]
                        if hi == 0x5C and j + 3 < n:
                            j += 1
                            hi = self.spec[j + 2]
                        if hi < c:
                            raise ValueError(
                                f"empty range {chr(c)}-{chr(hi)} in grep class")
                        ranges.append((c, hi))
                        j += 3
                    else:
                        ranges.append((c, c))
                        j += 1
                if j >= n:
                    raise ValueError("unterminated '[' class in grep pattern")
                if not ranges:
                    raise ValueError("empty [] class in grep pattern")
                self.classes.append((negated, tuple(ranges)))
                i = j + 1
            else:
                self.classes.append((False, ((b,) * 2,)))
                i += 1
        if not self.classes:
            raise ValueError("grep pattern must be non-empty")
        if len(self.classes) > 256:
            raise ValueError(f"grep pattern of {len(self.classes)} positions "
                             "exceeds the 256-position limit")
        for neg, ranges in self.classes:
            if not neg and any(lo <= 0 <= hi for lo, hi in ranges):
                raise ValueError("grep pattern must not match NUL bytes "
                                 "(the chunk padding byte)")

    def __len__(self) -> int:
        return len(self.classes)

    def tobytes(self) -> bytes:
        """Canonical serialization (job identity / checkpoint fingerprints),
        the JAX package's bytes."""
        out = [b"C1"]
        for neg, ranges in self.classes:
            out.append(bytes([1 if neg else 0, len(ranges)]))
            out.extend(bytes([lo, hi]) for lo, hi in ranges)
        return b"".join(out)


def _classes(pattern) -> list:
    """A compiled pattern's (negated, ranges) per position."""
    if isinstance(pattern, ClassPattern):
        return pattern.classes
    return [(False, ((int(b),) * 2,)) for b in pattern.tolist()]


def _position_hits(window: torch.Tensor, cls) -> torch.Tensor:
    """bool mask: window bytes allowed by one (negated, ranges) class."""
    neg, ranges = cls
    m = None
    for lo, hi in ranges:
        h = window == lo if lo == hi else (window >= lo) & (window <= hi)
        m = h if m is None else m | h
    if neg:
        m = ~m & (window != 0)  # padding can never match
    return m


def _match_mask(chunk: torch.Tensor, pattern) -> torch.Tensor:
    """bool[n]: True where an occurrence of ``pattern`` starts (a uint8
    numpy array, a literal, or a :class:`ClassPattern`)."""
    classes = _classes(pattern)
    m, n = len(classes), chunk.shape[0]
    hit = torch.zeros(n, dtype=torch.bool, device=chunk.device)
    if m > n:
        return hit
    run = hit[: n - m + 1]
    run.fill_(True)
    for i, cls in enumerate(classes):  # m shifted planes, ANDed in place
        run &= _position_hits(chunk[i: n - m + 1 + i], cls)
    return hit


#: Columns of the blocked running maximum (:func:`_running_max`).
_SCAN_COLS = 1024


def _running_max(v: torch.Tensor) -> torch.Tensor:
    """``torch.cummax(v, 0).values`` of a 1-D integer tensor, as a blocked
    scan: rows of ``_SCAN_COLS`` scanned side by side, then each row
    raised to the running maximum of the rows before it (the row maxima's
    own scan, by the same rule).  On the card torch scans one row per
    group of 16 threads, so a 1-D ``cummax`` of a 32 MB chunk is one
    serial block (~90 ms on an H100); blocked, it is three short scans."""
    n = v.shape[0]
    if n <= _SCAN_COLS:
        return torch.cummax(v, 0).values
    rows = -(-n // _SCAN_COLS)
    low = torch.iinfo(v.dtype).min
    x = torch.cat([v, v.new_full((rows * _SCAN_COLS - n,), low)])
    within = torch.cummax(x.view(rows, _SCAN_COLS), 1).values
    carry = _running_max(within[:, -1].contiguous())
    within[1:] = torch.maximum(within[1:], carry[:-1, None])
    return within.view(-1)[:n]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True (0 when none: test ``any`` beside it)."""
    return torch.argmax(mask.to(torch.uint8))


def _row_summary_multi(chunk: torch.Tensor, patterns: list,
                       marks: Optional[list] = None):
    """Per-chunk line-boundary summaries for a pattern list: ``[P]`` int64
    tensors ``(matches, seg_cnt, nl, first_m, last_m)``, the JAX
    package's, on the device and without a host read.  ``marks``, when
    given, gets each pattern's bool mask of the matches that are the first
    of their line within the chunk (the records mode's emit).

    ``seg_cnt`` counts newline-delimited segments with >= 1 match (leading
    and trailing partial segments included), ``nl`` = the chunk has a
    newline (the same for every pattern), ``first_m``/``last_m`` = the
    leading/trailing segment matched.  The JAX conventions, copied: a
    position's match is "seen before" when an earlier position of the scan
    segment of its predecessor matched, a newline resetting the scan at
    its own position; the first newline belongs to the first segment, and
    the last newline does not belong to the last one.  Padding NULs
    extend the trailing segment and never match.
    """
    n = chunk.shape[0]
    newline = chunk == 0x0A
    any_nl = newline.any()
    # seg[i]: newlines at or before i, so a newline starts its own scan
    # segment (the reset at its own position).
    seg = torch.cumsum(newline, 0, dtype=torch.int32)
    first_nl = torch.where(any_nl, _first_true(newline), n - 1)
    last_nl = torch.where(any_nl, n - 1 - _first_true(newline.flip(0)), -1)
    out = []
    for p in patterns:  # one pattern's planes live at a time
        hit = _match_mask(chunk, p)
        any_hit = hit.any()
        # inc[i]: a match at or before i in i's scan segment, i.e. the
        # running maximum of seg over matched positions is seg[i] (seg is
        # nondecreasing, so no earlier segment can reach it).
        best = _running_max(torch.where(hit, seg, -1))
        inc = best == seg
        first_in_line = hit.clone()
        first_in_line[1:] &= ~inc[:-1]
        if marks is not None:
            marks.append(first_in_line)
        first_hit = _first_true(hit)
        last_hit = n - 1 - _first_true(hit.flip(0))
        out.append(torch.stack([
            hit.sum(), first_in_line.sum(),
            any_nl.to(torch.int64),
            (any_hit & (first_hit <= first_nl)).to(torch.int64),
            (any_hit & (last_hit > last_nl)).to(torch.int64)]))
    return tuple(torch.stack(out, 1))


def _row_summary(chunk: torch.Tensor, pattern):
    """The P=1 case of :func:`_row_summary_multi`, as scalars."""
    return tuple(x[0] for x in _row_summary_multi(chunk, [pattern]))


def _whole_buffer_state(chunk: torch.Tensor, patterns: list) -> GrepState:
    """``[P]``-leaf GrepState treating the chunk as a whole corpus:
    ``lines`` is the exact segment count and ``line_carry`` the trailing
    open line's match bit."""
    matches, seg_cnt, nl, first_m, last_m = _row_summary_multi(chunk,
                                                               patterns)
    zero = torch.zeros_like(matches)
    return GrepState(matches_lo=matches, matches_hi=zero,
                     lines_lo=seg_cnt, lines_hi=zero.clone(),
                     line_carry=torch.where(nl > 0, last_m, first_m))


def count_matches_in_chunk(chunk: torch.Tensor, pattern) -> GrepState:
    """One chunk's (occurrences, matching lines): the P=1 case of
    :func:`_whole_buffer_state`, as scalar leaves."""
    return GrepState(*(x[0] for x in _whole_buffer_state(chunk, [pattern])))


def _validate_pattern(pattern: bytes) -> np.ndarray:
    """Single owner of the literal-pattern rules; returns the uint8 view."""
    if not pattern:
        raise ValueError("grep pattern must be non-empty")
    if len(pattern) > 256:
        raise ValueError(f"grep pattern of {len(pattern)} bytes exceeds "
                         "the 256-byte limit (the match mask unrolls one "
                         "fused comparison per pattern byte)")
    if 0 in pattern:
        # NUL is the chunk padding byte: a NUL-bearing pattern would
        # count phantom matches in padding tails.
        raise ValueError("grep pattern must not contain NUL bytes")
    return np.frombuffer(pattern, dtype=np.uint8)


def compile_pattern(pattern: bytes, syntax: str = "literal"):
    """Compile a pattern spec: 'literal' -> uint8 view, 'class' ->
    :class:`ClassPattern` (regex-lite byte classes)."""
    if syntax == "class":
        return ClassPattern(pattern)
    if syntax != "literal":
        raise ValueError(f"unknown grep syntax {syntax!r} "
                         "(expected 'literal' or 'class')")
    return _validate_pattern(pattern)


def _single_row_update(matches, seg_cnt, nl, first_m, last_m) -> GrepUpdate:
    """One chunk's summary as its own boolean-affine transfer: ``a`` = the
    trailing (or, newline-free, only) segment's match, ``b`` = no newline,
    ``delta`` = leading segment matched.  Scalar and ``[P]`` summaries
    alike."""
    return GrepUpdate(matches, torch.zeros_like(matches), seg_cnt, first_m,
                      torch.where(nl > 0, last_m, first_m),
                      (nl == 0).to(torch.int64))


def _compose_transfer(x, y):
    """Boolean-affine composition: y applied after x."""
    ax, bx = x
    ay, by = y
    return ay | (by & ax), bx & by


def _seam_corrected_update(matches, seg_cnt, nl, first_m, last_m,
                           gathered: torch.Tensor,
                           device_index: int) -> GrepUpdate:
    """The seam correction of the JAX package's sharded map, from the
    step's gathered row summaries ``gathered`` (``[D, 3, ...]``: each
    device's ``nl``, ``first_m``, ``last_m`` in row order): this device's
    incoming carry by prefix composition, and its corrected contribution."""
    nl_g, fm_g, lm_g = gathered[:, 0], gathered[:, 1], gathered[:, 2]
    # Row transfer c' = a | (b & c): a newline row pins c to its trailing
    # match; a newline-free row is transparent (first == last == any).
    a_row = torch.where(nl_g > 0, lm_g, fm_g)
    b_row = (nl_g == 0).to(torch.int64)
    incl = [(a_row[0], b_row[0])]
    for d in range(1, a_row.shape[0]):
        incl.append(_compose_transfer(incl[-1], (a_row[d], b_row[d])))
    excl = (torch.zeros_like(a_row[0]), torch.ones_like(b_row[0])) \
        if device_index == 0 else incl[device_index - 1]
    c_d = excl[0]  # incoming bit, step carry 0
    corrected = (seg_cnt - (first_m & c_d)) & MASK32
    # If the step's incoming carry is 1, rows whose whole prefix is
    # transparent and unmatched additionally see c = 1.
    delta = first_m & excl[1] & (1 - c_d)
    return GrepUpdate(matches, torch.zeros_like(matches), corrected, delta,
                      incl[-1][0], incl[-1][1])


class GrepJob:
    """Pattern-occurrence counting as a MapReduce job."""

    def __init__(self, pattern: bytes, syntax: str = "literal", device=None):
        self.pattern = compile_pattern(pattern, syntax)
        self.device = resolve_device(device)

    def _zeros(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def init_state(self) -> GrepState:
        return GrepState(*(self._zeros() for _ in GrepState._fields))

    def _summary(self, chunk: torch.Tensor):
        return _row_summary(chunk, self.pattern)

    def map_chunk(self, chunk: torch.Tensor, chunk_id) -> GrepUpdate:
        """The single-row transfer (no step axis): exact when rows are
        driven sequentially through map_chunk + combine."""
        return _single_row_update(*self._summary(chunk))

    def map_chunk_sharded(self, chunk: torch.Tensor, chunk_id, axis=None,
                          device_index: int = 0) -> GrepUpdate:
        """The streamed map: one all_gather of the row summaries over the
        data axis (without an axis, a leading axis of 1), then the seam
        correction."""
        from mapreduce_tpu_torch.parallel import collectives

        summ = self._summary(chunk)
        gathered = collectives.all_gather(torch.stack(summ[2:]), axis)
        return _seam_corrected_update(*summ, gathered, device_index)

    def combine(self, state: GrepState, update: GrepUpdate) -> GrepState:
        # Out of place: the input state may be a replay's anchor.
        m_lo, m_hi = add64(state.matches_lo, state.matches_hi,
                           update.matches_lo, update.matches_hi)
        lines = (update.lines - (state.line_carry & update.delta)) & MASK32
        l_lo, l_hi = add64(state.lines_lo, state.lines_hi, lines, 0)
        carry = update.blk_a | (update.blk_b & state.line_carry)
        return GrepState(m_lo, m_hi, l_lo, l_hi, carry)

    def on_input_boundary(self, state: GrepState) -> GrepState:
        """Files are independent line streams: the open-line carry resets
        at a corpus-member boundary."""
        return state._replace(line_carry=torch.zeros_like(state.matches_lo))

    def partial_reset(self, local: GrepState) -> GrepState:
        """Fresh counts that keep the carry (cross-step context)."""
        return self.init_state()._replace(line_carry=local.line_carry)

    def map_chunk_stats(self, chunk: torch.Tensor, chunk_id, axis=None,
                        device_index: int = 0):
        """Stats-mode map: grep has no kernel window, rescue or table, so
        the chunk counters are the chunk itself; :meth:`state_stats` fills
        the gauges."""
        return (self.map_chunk_sharded(chunk, chunk_id, axis, device_index),
                datastats.map_stats())

    def state_stats(self, state: GrepState, stats):
        """Grep's data volume is its match count, summed over patterns:
        the data record's ``tokens``."""
        total = state.matches_lo + (state.matches_hi << 32)
        return stats._replace(tokens=total.sum())

    def analysis_observables(self, state: GrepState):
        """The leaves the analysis's merge property check compares: the
        counts.  ``line_carry`` is coordination state, equal on every rank
        within a run, but states of DIFFERENT chunks disagree on it, which
        a bitwise commutativity check would misread as a reducer bug."""
        return (state.matches_lo, state.matches_hi,
                state.lines_lo, state.lines_hi)

    def merge(self, a: GrepState, b: GrepState) -> GrepState:
        """Two states of one run (their carries agree: either will do)."""
        m_lo, m_hi = add64(a.matches_lo, a.matches_hi,
                           b.matches_lo, b.matches_hi)
        l_lo, l_hi = add64(a.lines_lo, a.lines_hi, b.lines_lo, b.lines_hi)
        return GrepState(m_lo, m_hi, l_lo, l_hi, a.line_carry)

    def finalize(self, state: GrepState) -> GrepState:
        return state

    def identity(self) -> str:
        # The pattern is the job; a class pattern gets its own prefix.
        kind = "grepc" if isinstance(self.pattern, ClassPattern) else "grep"
        return f"{kind}:" + hashlib.sha256(
            self.pattern.tobytes()).hexdigest()[:16]


class MultiGrepJob(GrepJob):
    """P patterns counted in one pass over the corpus: ``[P]`` leaves; the
    combine, merge and boundary math is shape-polymorphic and inherited."""

    def __init__(self, patterns, syntax: str = "literal", device=None):
        if not patterns:
            raise ValueError("need at least one grep pattern")
        self.patterns = [compile_pattern(p, syntax) for p in patterns]
        self.device = resolve_device(device)

    def _zeros(self) -> torch.Tensor:
        return torch.zeros((len(self.patterns),), dtype=torch.int64,
                           device=self.device)

    def _summary(self, chunk: torch.Tensor):
        return _row_summary_multi(chunk, self.patterns)

    def identity(self) -> str:
        h = hashlib.sha256()
        kinds = ""
        for p in self.patterns:
            kinds += "c" if isinstance(p, ClassPattern) else "l"
            h.update(len(p.tobytes()).to_bytes(4, "little") + p.tobytes())
        return f"grep{len(self.patterns)}{kinds[:8]}:" + h.hexdigest()[:16]


class GrepResult(NamedTuple):
    """Host-side result."""

    pattern: bytes
    matches: int  # overlapping occurrences
    lines: int  # matching lines (exact, incl. lines split across chunks)


def _state_result(pattern: bytes, state) -> GrepResult:
    return GrepResult(pattern,
                      int(state.matches_lo) + (int(state.matches_hi) << 32),
                      int(state.lines_lo) + (int(state.lines_hi) << 32))


def _multi_results(patterns: list, state) -> list:
    """Split a ``[P]``-leaf state into per-pattern results."""
    m = (state.matches_lo + (state.matches_hi << 32)).tolist()
    ln = (state.lines_lo + (state.lines_hi << 32)).tolist()
    return [GrepResult(p, m[i], ln[i]) for i, p in enumerate(patterns)]


def _padded_chunk(data, device) -> torch.Tensor:
    """A buffer on the device, NUL-padded to a multiple of 128 bytes."""
    buf = np.frombuffer(data, dtype=np.uint8)
    padded = tok_ops.pad_to(buf, max(128, -(-max(buf.shape[0], 1) // 128)
                                     * 128))
    return torch.from_numpy(padded).to(resolve_device(device))


def grep_bytes(data: bytes, pattern: bytes, syntax: str = "literal",
               device=None) -> GrepResult:
    """One-call API: pattern counts for an in-memory buffer."""
    pat = compile_pattern(pattern, syntax)
    state = count_matches_in_chunk(_padded_chunk(data, device), pat)
    return _state_result(pattern, state)


def grep_bytes_multi(data: bytes, patterns: list, syntax: str = "literal",
                     device=None) -> list:
    """One-call multi-pattern API: P patterns, one pass over the buffer."""
    if not patterns:
        raise ValueError("need at least one grep pattern")
    pats = [compile_pattern(p, syntax) for p in patterns]
    state = _whole_buffer_state(_padded_chunk(data, device), pats)
    return _multi_results(patterns, state)


def grep_file(path, pattern: bytes, config: Config = DEFAULT_CONFIG,
              device=None, syntax: str = "literal", **kw) -> GrepResult:
    """Pattern counts over a file (or a list of files, one corpus) through
    the streamed executor; ``kw`` goes to ``run_job`` (checkpoints, retry,
    telemetry)."""
    from mapreduce_tpu_torch.runtime import executor

    rr = executor.run_job(GrepJob(pattern, syntax, device), path, config,
                          **kw)
    return _state_result(pattern, rr.value)


def grep_file_multi(path, patterns: list, config: Config = DEFAULT_CONFIG,
                    device=None, syntax: str = "literal", **kw) -> list:
    """P patterns over a file through the streamed executor: one ingest,
    one pass a chunk, P exact (matches, lines) pairs."""
    from mapreduce_tpu_torch.runtime import executor

    rr = executor.run_job(MultiGrepJob(patterns, syntax, device), path,
                          config, **kw)
    return _multi_results(patterns, rr.value)


# -- records mode: the matching lines themselves -----------------------------


def _admits_newline(pattern) -> bool:
    """Can some position of a compiled pattern match LF?"""
    for neg, ranges in _classes(pattern):
        inside = any(lo <= 0x0A <= hi for lo, hi in ranges)
        if inside != neg:
            return True
    return False


class GrepRecordsState(NamedTuple):
    """The records mode's running state: the counts, and the emitted
    positions as a list of ``(chunk_id, positions)`` cells, newest first
    (``(item, rest)``, None when empty), so a combine adds one cell and
    never copies or edits the list it extends."""

    counts: GrepState
    emitted: Any = None


class GrepRecordsUpdate(NamedTuple):
    """One chunk's counts update and its emitted positions: the in-chunk
    offsets, ascending, of the matches that open their line within the
    chunk (int64, on the host)."""

    counts: GrepUpdate
    chunk_id: int
    positions: torch.Tensor


def _emit(marks: torch.Tensor) -> torch.Tensor:
    """The marked positions of a chunk, compacted on the device and copied
    to the host: one declared host read of their count
    (``executor.host_syncs{site=emit}``, through the streamed driver's
    deadline reader when it sets one), a compaction of that size, and a
    copy into pinned memory on the compute stream, which the host reads
    only after the run's last completion token.  No cap: every marked
    position is kept; positions that memory cannot hold raise an
    out-of-memory ``MemoryError`` with their count, which the failure
    policy classes as ``resource``."""
    with span("grep.emit"):
        n = tracepoints.host_read(marks.sum().view(1), site="emit")[0]
        if not n:
            return torch.empty(0, dtype=torch.int64)
        try:
            pos = torch.nonzero_static(marks, size=n).view(-1)
            if pos.device.type != "cuda":
                return pos
            host = torch.empty(n, dtype=torch.int64, pin_memory=True)
        except (torch.cuda.OutOfMemoryError, MemoryError) as e:
            raise MemoryError(
                f"grep records: out of memory for a chunk's {n} "
                f"matching-line positions ({8 * n} bytes on the card and in "
                "pinned host memory)") from e
        host.copy_(pos, non_blocking=True)
        return host


def _cells(emitted) -> list:
    """The ``(chunk_id, positions)`` items of an emitted list."""
    out = []
    while emitted is not None:
        item, emitted = emitted
        out.append(item)
    return out


class GrepRecordsJob(GrepJob):
    """One pattern's counts and the positions of its matching lines, as a
    MapReduce job (:func:`grep_records`).

    The counts are :class:`GrepJob`'s.  Each chunk also emits the first
    match of each line within it (:func:`_emit`); the host finds the lines
    around them (:func:`recover_records`).  A line cut by a chunk seam may
    be emitted by both chunks: the host merges by line.  The state grows
    with the emitted positions, so the executor refuses a snapshot, a byte
    range and a mesh of more than one rank for it (``fixed_state``).
    Under ``retry`` a replay restarts from a kept state, which holds only
    the positions of the chunks before it, so a replayed chunk emits once.
    """

    fixed_state = False

    def __init__(self, pattern: bytes, syntax: str = "literal", device=None):
        super().__init__(pattern, syntax, device)
        if _admits_newline(self.pattern):
            raise ValueError("a grep records pattern must not match LF: a "
                             "record is one line")

    def init_state(self) -> GrepRecordsState:
        return GrepRecordsState(super().init_state())

    def map_chunk_sharded(self, chunk: torch.Tensor, chunk_id, axis=None,
                          device_index: int = 0) -> GrepRecordsUpdate:
        """:class:`GrepJob`'s streamed map, and the chunk's emit."""
        from mapreduce_tpu_torch.parallel import collectives

        marks: list = []
        summ = tuple(x[0] for x in _row_summary_multi(chunk, [self.pattern],
                                                      marks))
        gathered = collectives.all_gather(torch.stack(summ[2:]), axis)
        return GrepRecordsUpdate(
            _seam_corrected_update(*summ, gathered, device_index),
            int(chunk_id), _emit(marks[0]))

    def combine(self, state: GrepRecordsState,
                update: GrepRecordsUpdate) -> GrepRecordsState:
        counts = super().combine(state.counts, update.counts)
        emitted = state.emitted
        if update.positions.numel():
            emitted = ((update.chunk_id, update.positions), emitted)
        return GrepRecordsState(counts, emitted)

    def on_input_boundary(self, state: GrepRecordsState) -> GrepRecordsState:
        return state._replace(counts=super().on_input_boundary(state.counts))

    def partial_reset(self, local: GrepRecordsState) -> GrepRecordsState:
        """Fresh counts that keep the carry, and no positions: they went
        into the accumulator."""
        return GrepRecordsState(super().init_state()._replace(
            line_carry=local.counts.line_carry))

    def state_stats(self, state: GrepRecordsState, stats):
        return super().state_stats(state.counts, stats)

    def merge(self, a: GrepRecordsState,
              b: GrepRecordsState) -> GrepRecordsState:
        emitted = b.emitted  # in any order: recovery sorts by chunk
        for item in _cells(a.emitted):
            emitted = (item, emitted)
        return GrepRecordsState(super().merge(a.counts, b.counts), emitted)

    def identity(self) -> str:
        return "records-" + super().identity()


@dataclasses.dataclass
class GrepRecords:
    """The records mode's result: :class:`GrepResult`'s counts and the
    matching lines."""

    pattern: bytes
    matches: int  # overlapping occurrences
    lines: int  # matching lines
    records: list  # each matching line's bytes without its LF, file order
    run: Any = None  # the run's RunResult, its value dropped


def recover_records(emitted, path, bases: np.ndarray) -> list:
    """The matching lines of a records run, in file order: each emitted
    position as a virtual corpus offset (the row ``bases``), its line's
    bounds from the file (:func:`...data.reader.line_bounds_at_multi`),
    one record a line however many positions fall in it, and the lines'
    bytes (:func:`...data.reader.read_words_at_multi`, under
    ``recover.read``)."""
    from mapreduce_tpu_torch.data import reader as reader_mod
    from mapreduce_tpu_torch.runtime.executor import absolute_offsets

    cells = sorted(_cells(emitted), key=lambda cell: cell[0])
    if not cells:
        return []
    chunk_id = np.repeat([c for c, _ in cells],
                         [p.numel() for _, p in cells])
    pos = np.concatenate([p.numpy() for _, p in cells])
    offsets = absolute_offsets(chunk_id, pos, bases, bases.shape[1])
    starts, ends = reader_mod.line_bounds_at_multi(path, offsets)
    first = np.flatnonzero(np.r_[True, starts[1:] != starts[:-1]])
    with span("recover.read"):
        return reader_mod.read_words_at_multi(path, starts[first],
                                              ends[first] - starts[first])


def grep_records(path, pattern: bytes, config: Config = DEFAULT_CONFIG,
                 device=None, syntax: str = "literal", **kw) -> GrepRecords:
    """The Pavlo et al. grep task over a file (or a list of files, one
    corpus): the counts of :func:`grep_file` and every matching line, in
    file order, without its LF.  Runs through ``run_job`` (``kw``: retry,
    telemetry, logger, progress); the host's work after the stream is the
    ``recover`` phase of the result's ``run``, and its span
    ``grep.records`` (line bounds, reads and the result).  One pattern,
    which may not match LF, with the counts' envelope (a pattern holding a
    separator never matches across a chunk seam); one rank, the whole
    corpus and no snapshot (the executor refuses the rest)."""
    from mapreduce_tpu_torch.obs.spans import timing_into
    from mapreduce_tpu_torch.runtime import executor
    from mapreduce_tpu_torch.runtime.metrics import PhaseTimer

    rr = executor.run_job(GrepRecordsJob(pattern, syntax, device), path,
                          config, **kw)
    timer = PhaseTimer(phases=rr.metrics.phases)
    with span("recover", timer), timing_into(timer), span("grep.records"):
        counts = _state_result(pattern, rr.value.counts)
        records = recover_records(rr.value.emitted, path, rr.bases)
    return GrepRecords(pattern, counts.matches, counts.lines, records,
                       run=dataclasses.replace(rr, value=None))
