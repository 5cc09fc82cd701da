#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports only the port (``mapreduce_tpu_torch``), never JAX, and exits
non-zero when no card is present.  Phases, each printing JSON lines:

1. build   -- compile every ``mapreduce_tpu_torch/csrc/*.cu`` with nvcc,
              one process per source, all started together, and the host
              chunker ``mapreduce_tpu_torch/native/chunker.cpp`` with g++;
2. kernel  -- each kernel's public wrapper against its plain PyTorch
              version on the card, exact equality:
              the tokenize kernel in compact and pair mode (a 32 MB Zipf
              chunk, a dense chunk that must spill, overlong runs at window
              and chunk edges, a chunk of exactly ``pallas_min_chunk``
              bytes); its fused mode against the compact plain version
              on the same probes; the hot-key combiner kernel (stream, cache planes and
              counters) on the 32 MB chunk, ``b"a b "`` (two keys: the cache
              takes every occurrence), a chunk of two-letter tokens whose
              thinned windows must spill, runs at combiner window and
              segment edges, a 4 MB single-key chunk and a 32 MB chunk
              dominated by one word, and each of its three launches
              (heads, merge, thin) against its plain version on the two
              32 MB chunks; the radix seam on the 32 MB chunk's compact
              stream, the one-word chunk's, the same rows in one bucket,
              random triples with ``key_hi >= 2**31``, random triples with
              one hot key and an all-dead stream: each level on its own
              against the plain partition row for row, the segmented sort
              against its plain version, and the whole seam, both impls,
              against the 3-key sort (key-only under stable2's
              position-ordered input);
3. words   -- ``count_words`` at ``Config()`` defaults (32 MB chunk, table
              capacity 2**18) on a seeded 32 MB corpus, equal to the oracle;
4. stream  -- ``count_file`` (through ``run_job``) over a seeded corpus
              of at least 128 MB (4 chunks or more), equal to the oracle;
5. paths   -- the same entry points under ``map_impl='fused'``; under
              ``combiner='hot-cache'`` (``count_words`` on 32 MB and
              ``count_file`` on 66 MB, each with a dense region of more
              distinct keys than the cache holds, so one chunk takes the
              combiner-free rerun of the dense stream); and under
              ``sort_impl`` 'radix_partition' and 'radix'; each equal to the
              oracle;
6. stream_pipeline -- the pipelined executor (``run_job``: prefetching
              reader with the native chunker, pinned staging, H2D on a
              copy stream, a window of groups retired through CUDA events)
              over the phase-4 file passed 8 times as one corpus (~1.09 GB,
              40 chunks; each file's end is a token boundary, so the
              expected result is phase 4's oracle with every count x 8):
              three turns of the default window (4) and the serial control
              (``inflight_groups=1``, ``prefetch_depth=1``), each printing
              GB/s, every phase, the window statistics, the overlap
              fraction, the pinned H2D ms a chunk and the native
              chunker's fills (one a chunk, or it fails); pinned against
              pageable H2D of one 32 MB chunk; a ``torch.profiler`` profile
              of a streamed run over two of the files (the card's busy
              share and the idle gap after each chunk's host read); and a
              subprocess running ``run_job`` with a snapshot every 8 steps,
              killed with SIGKILL once its first snapshot and ``.sum``
              landed, then resumed here;
7. faults  -- the failure policy, fault plans and preemption of
              ``run_job`` at ``Config()`` defaults over the phase-4 file (5
              chunks), each run against the oracle: one injected transient
              fault at each seam the port crosses (``retry=2``; window 4 and
              window 1; ``process-kill`` in a child that exits 113 and is
              resumed), with the replay's milliseconds; a seeded random plan
              and the faults it fired; a resource storm at ``dispatch``
              that walks the degradation ladder from ``fused`` /
              ``hot-cache`` / ``radix`` (window 1, so each rung runs a
              step: the kernels each rung launched) and an exhausted ladder,
              which must fail as ``resource``; a real late completion
              (``torch.cuda._sleep`` of 0.6 s queued before the first
              step's map, window 4) past a ``token_timeout_s`` of 0.2 s,
              replayed, and a hung one (6 s, before the third step's map),
              which must end the run with a ``TokenTimeout`` in under 3 s; a
              real CUDA out-of-memory in a child capped by
              ``set_per_process_memory_fraction``, which must come out exact
              or fail as ``resource`` and nothing else; SIGINT to a child
              ``python -m mapreduce_tpu_torch --stream --checkpoint`` over
              the 8-file corpus once its first snapshot landed (plain and
              ``--top-k 5``), which must exit 75 and whose relaunch must
              print what an uninterrupted run prints.  First of all, in a
              fresh process: ``count_file`` over the 8-file corpus at
              ``retry=0`` against ``retry=1`` (the cost of the anchor and the
              held buffers), in turns 0, 1, 1, 0, one turn (across ranks,
              phase 11 adds its own turns); beside it, one ``retry=0`` run
              in this process right after phase 6 and one after every
              other case;
8. telemetry -- the run ledger, metrics registry, flight recorder,
              data-plane statistics and profiler of ``run_job`` at
              ``Config()``, each run against the oracle, the ledgers read
              with the port's own ``obs.ledger`` and ``obs.timeline``: a
              ledger'd run over the 8-file corpus (record kinds in order,
              one ``group`` record per retired group with ordered stamps,
              the card's memory in every ``step`` record, the timeline's
              lanes, idle blame and bottleneck printed beside the run's
              phase split); a ledger'd ``map_impl='fused'``,
              ``combiner='hot-cache'``, ``sort_impl='radix'`` run over the
              phase-4 file with a pairs region (one chunk takes the
              combiner-free rerun), whose ``data`` record's combiner
              counters must equal the run's branch counts; a chaotic run
              (``seed=7,rate=0.2,classes=transient+resource,max=6``,
              ``retry=2``) whose ledger, replayed as a plan, fires the same
              crossings, and an absorbed ``ledger-append`` fault; a
              permanent fault through the CLI, which must leave a
              ``failure`` record and a flight dump naming its step; the CLI
              in a child with ``--ledger``, ``--metrics-out`` and
              ``--profile`` (stdout equal to the plain run's, the
              registry's retired groups equal to the ledger's ``group``
              records, the trace holding the spans and the
              ``tokenize_stream`` kernel); the host's synchronising runtime
              calls of a profiled 2-file run with and without telemetry
              (no more with); and streamed GB/s with and without telemetry
              over the 8-file corpus in a fresh process, in turns off,
              registry only, ledger, ledger, registry only, off, two
              turns, and the host microseconds of each part of a group's
              telemetry (the memory read, the two records' writes, the
              gauges and their copy);
9. families -- the n-gram and sketched word-count families at
              ``Config()``, each run against a host oracle (token spans in
              numpy, token keys by the port's host mirror ``hash_word``,
              gram keys folded in numpy; past the 2**18 table the oracle
              keeps the 2**18 smallest keys, each with its exact count):
              ``count_ngrams`` n = 2 and 3 on phase 3's corpus and on a
              copy with 40 overlong URLs in 1,000 tokens (their grams
              dropped and accounted), n = 2 under ``sort_impl='radix'``
              and ``map_impl='fused'``; ``count_file`` with n = 2 and 3
              over the phase-4 file and n = 2 over the 8-file corpus, with
              the seam entries formed at the chunk joins (> 0; n-1
              windows a join inside a file, counted or poisoned, none
              across files) and those the host recovers; SIGINT to a
              ``--stream --ngram 2 --checkpoint`` CLI child, which must
              exit 75 and whose relaunch must print what an uninterrupted
              run prints; distinct- and count-sketched ``count_file`` over
              four 32 MB regions of 120,000 words each (~480,000 distinct,
              past the table), whose registers and Count-Min cells must
              equal the host's, whose estimate must lie within 3 % with
              ``dropped_uniques > 0``, whose estimate of sampled spilled
              words must not fall below their counts, at
              ``sketch_flush_every`` 1 and 4; then streamed GB/s of n = 2
              against the word count (8 files, in turns), the n-gram step
              of one 32 MB chunk beside the word count's with the rows
              each sort sees, one HLL and one CMS update's ms, and the
              phase's wall time;
10. grep_sample -- grep and the reservoir sample at ``Config()``, each
              run against a numpy oracle: ``grep_bytes`` on phase 3's 32 MB
              corpus and ``grep_file`` over the phase-4 file and the 8-file
              corpus, for ``the``, a 32-byte literal, a class pattern with a
              space (``[a-z]e [t-z]``) and four patterns in one pass, one of
              them ``\\nt`` (overlapping matches, and lines under the JAX
              segment convention, with no match across a chunk join: the
              oracle drops those at the run's own row bases); then
              ``sample_bytes`` and ``sample_file`` with k = 16 and 4,096 on
              the same inputs (token spans, the priorities of (chunk id,
              offset), the bottom-k by lexsort, the population without the
              tokens longer than W), each sample path launching pair mode
              once a chunk and taking no fallback, and no path reading the
              host in a step; streamed GB/s of grep (one and four
              patterns) and the sample against the word count over the
              8-file corpus, in turns; one 32 MB chunk's step ms, device ms,
              kernel launches, peak memory and host syncs of each job; and
              the phase's wall time;
11. many_ranks -- the streamed run over D ranks of one
              ``torch.distributed`` world, one process a rank
              (``MANY_RANKS_CHILD``): prints ``torch.cuda.device_count()``,
              then an NCCL world of ``min(device_count, 4)`` ranks (one
              card a rank) and a gloo world of 2 ranks asked for
              explicitly, both on card 0 (the kernels on the card, the
              collectives through the host), each over the phase-4 file:
              ``count_file`` with the tree, gather and keyrange merges,
              ``--ngram 2`` (grams cross the join between ranks in every
              step), grep with four patterns and the sample with k =
              4,096; every run held to one rank's run on the card and to
              the oracle (the sample to the oracle of D rows a step),
              every rank's K1a/K1b launches one a step, and per world the
              finish ms, the bytes each rank sent by collective, the
              launches per rank and the per-step all_gather ms of the
              n-gram and grep maps; any rank's failure or a join past its
              time limit fails the smoke.  Both worlds also run, over the
              8-file corpus (``rank_cases``, held by ``hold_rank_cases``),
              the word count with ``merge_overlap`` under tree, gather and
              keyrange, bigrams and grep with four patterns, each against
              one rank's run, the oracle and the partials
              ``predicted_partials`` gives (each partial's interval and the
              residual finish from the coordinator's ledger), GB/s in
              turns (overlap on, off, off, on; ``retry`` 1, 0, 0, 1), a
              dispatch fault under ``retry=2`` on every rank and on rank 1
              alone (the replay ms) and a resource storm that walks the
              ladder on every rank, with the agreement's µs a crossing;
              then a real SIGINT to rank 1 of a 2-rank CLI world
              (``cli_world``, gloo on card 0) once its first snapshot
              landed: both ranks must exit 75 and the relaunch print what
              one uninterrupted rank prints;
12. many_hosts -- the streamed run over several hosts, one process a
              rank (``MANY_HOSTS_CHILD``): a gloo world of 4 ranks on card
              0 laid out as 2 hosts of 2 (``LOCAL_WORLD_SIZE`` 2,
              ``GROUP_RANK`` the node) over ``two_level_mesh(2, 2)``, and
              an NCCL world of ``min(device_count, 4)`` ranks, one host,
              over ``two_level_mesh(1, n)``, each over the phase-4 file at
              ``Config()``: ``count_file`` with tree, gather, keyrange,
              hier-tree-tree and hier-kr-tree, ``--ngram 2``, grep with
              four patterns, mode (a) (each host's aligned
              ``host_byte_range`` over its own ranks, the partial tables
              merged by a tree across hosts, the partial counts summed
              here), and ``run_job_global`` over the world (with a ledger:
              one shard a host, each record stamped with its host) and
              over the two-level mesh; the gloo world's last case plans a
              ``process-kill`` at the same crossing on every rank (each
              exits 113 after the coordinator's snapshot) and a fresh
              world resumes; every result held to one rank's run and to
              the oracle, every rank's K1a/K1b launches one a step, and
              per world and case the finish ms, the bytes each rank sent
              by collective and level, and the launches per rank.  The
              gloo world's kill and resume run with ``merge_overlap`` (a
              window of one, a partial at the first checkpoint before the
              kill), and it adds phase 11's new cases over the 8-file
              corpus under all five strategies (no GB/s turns); the NCCL
              world adds the two ``hier-*`` overlaps;
13. knobs  -- the map's remaining knobs on the card: ``combiner='salt'``
              (``count_words`` on the 32 MB one-word and Zipf corpora
              under the torch sort and the radix seam, each equal to
              ``combiner='off'`` and the oracle, the Zipf one with a
              2**20-key table that holds its salted segments; at the
              default 2**18 the salted cutoff spills, as in the JAX
              package, and every occurrence stays accounted; step ms
              salted against off in turns and the radix seam's ms on the
              one-word stream salted and not); ``sort_mode='segmin'`` (equal to stable2
              without the rescue; step ms of stable2, sort3 and segmin in
              turns and the segmented minimum's device ms from the
              profiler); ``merge_every=4`` over the 8-file corpus equal to
              ``merge_every=1`` (GB/s in turns on, off, off, on), and a
              run killed at the process-kill seam just after a snapshot
              taken mid-buffer and resumed exact (phase 11's gloo world of
              2 adds a tree case at ``merge_every=4``); the geometries
              ``combiner16`` (fused, hot-cache), ``tall512`` and radix
              digit widths 2 and 5, each equal to the default, with the
              cache depth and digit width each wrapper was called with,
              ``run_start``'s geometry label and ``geometry_spec``, and a
              resource storm at ``tall512`` whose first rung is
              ``revert-geometry``; a byte-class histogram, a user's
              ``MapReduceJob``, through the ``Engine`` equal to numpy.
              Phase 2 holds K1d at cache depths 8, 16, 24 and 32 and
              K2's levels, segmented sort and seam at digit widths 1 to 5;
14. times  -- each kernel's median time per 32 MB chunk beside its bound,
              its plain version's time and a library call's where one
              exists (the segmented sort's: one lexsort with the group
              index first), and the time of each launch of the combiner
              and the radix seam (CUDA events between launches); the
              chunk's end-to-end time by stage; the step time (map +
              merge) of every path's configuration on one chunk, with the
              rows each step's sort sees;
15. profile -- where the device time of a default, a combiner and a
              radix_partition step goes.

Phases 3 to 13 each drive a main path: the launch counters are set to 0
just before each and read just after it, and each must have launched
every kernel of its path (one tokenize launch per chunk; the radix paths
one partition level per chunk, two under 'radix', and one segmented
sort; the combiner paths the pair-mode rerun of the chunk that spills;
every streamed run one launch a chunk).
No path but the combiner's may take a spill fallback: the dense regions
of the other paths' corpora must not.  A kernel's ``launches`` in the kernels line are those of the
first path that runs it; ``launches_by_path`` gives every path.  Before the
last line it prints one ``{"kernels": [...]}`` line and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
MB = 1 << 20
LETTERS = b"etaoinshrdlcumwfgypbvkjxqz"
# Two-letter tokens: 676 keys, so a window keeps most of its 1,024 rows
# under an 8-key cache and spills.
PAIRS = b" ".join(bytes([a, b]) for a in LETTERS for b in LETTERS) + b" "


#: The smoke's start, which every line's ``t`` (seconds) counts from.
T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw,
                      "t": round(time.perf_counter() - T0, 3)}), flush=True)


def make_corpus(n_bytes: int, seed: int, dense_at: int | None = None,
                urls_per_mille: int = 1) -> bytes:
    """Seeded English-like text: a Zipf(1.15) draw over 50,000 words whose
    length grows with rank, with ``urls_per_mille`` tokens in 1000 replaced
    by 40-120-byte URLs (longer than the kernel's W = 32: the overlong
    rescue).  ``dense_at`` puts 64 KB of one-letter tokens at that offset,
    denser than the compact budget, so that chunk takes the exact spill
    fallback."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab_n = 50_000
    ranks = np.arange(1, vocab_n + 1)
    lens = 1 + (np.log2(ranks + 1) * 0.45).astype(int) \
        + rng.integers(0, 3, vocab_n)
    letters = np.frombuffer(LETTERS, np.uint8)
    vocab = [bytes(letters[rng.integers(0, 26, n)]) for n in lens]
    n_urls = 4096
    url_lens = rng.integers(40, 121, n_urls)
    urls = [b"https://" + bytes(letters[rng.integers(0, 26, n - 8)])
            for n in url_lens]
    vocab = np.array(vocab + urls, dtype=object)
    seps = np.array([b" ", b" ", b" ", b"\n", b"  ", b"\t", b" \r\n"],
                    dtype=object)
    n_tok = n_bytes // 5 + 1024
    ids = (rng.zipf(1.15, n_tok) - 1) % vocab_n
    is_url = rng.integers(0, 1000, n_tok) < urls_per_mille
    ids[is_url] = vocab_n + rng.integers(0, n_urls, int(is_url.sum()))
    sep_ids = rng.integers(0, len(seps), n_tok)
    parts = np.empty(2 * n_tok, dtype=object)
    parts[0::2] = vocab[ids]
    parts[1::2] = seps[sep_ids]
    data = b"".join(parts.tolist())
    while len(data) < n_bytes:
        data += data[: n_bytes - len(data)]
    data = bytearray(data[:n_bytes])
    if dense_at is not None:
        data[dense_at:dense_at + 64 * 1024] = b"a b c d " * (8 * 1024)
    return bytes(data)


def with_pairs(data: bytes, at: int) -> bytes:
    """``data`` with 64 KB of two-letter tokens at ``at``: more keys than
    the hot-key cache holds, so the thinned window still spills."""
    buf = bytearray(data)
    region = (PAIRS * (64 * 1024 // len(PAIRS) + 1))[:64 * 1024]
    buf[at:at + len(region)] = region
    return bytes(buf)


def edge_chunk(n: int, w: int, window: int) -> bytes:
    """Runs of w-1, w, w+1 and 3w bytes at the chunk start, the chunk end
    and against every kernel window edge, in every placement."""
    buf = bytearray((b"ab cd " * (n // 6 + 1))[:n])
    runs = [w - 1, w, w + 1, 3 * w]
    places = [lambda e, r: e - r, lambda e, r: e - r + 1, lambda e, r: e,
              lambda e, r: e - r // 2]
    combos = [(r, p) for r in runs for p in places]
    for i, edge in enumerate(range(window, n - 4 * w, window)):
        run, place = combos[i % len(combos)]
        start = place(edge, run)
        buf[start - 1] = 0x20
        buf[start:start + run] = b"x" * run
        buf[start + run] = 0x20
    buf[0:3 * w] = b"s" * (3 * w)
    buf[3 * w] = 0x20
    buf[n - 3 * w - 1] = 0x20
    buf[n - 3 * w:] = b"e" * (3 * w)
    return bytes(buf)


def one_word_corpus(n_bytes: int, seed: int) -> bytes:
    """Seeded text in which one word is 90 % of the tokens (the rest a
    Zipf draw over 1,000 words): the hot-key probe of both kernels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = np.array([b"the"] + [b"w%d" % i for i in range(1000)],
                     dtype=object)
    m = n_bytes // 3
    ids = np.where(rng.random(m) < 0.9, 0, 1 + rng.zipf(1.2, m) % 1000)
    return b" ".join(vocab[ids].tolist())[:n_bytes].ljust(n_bytes, b" ")


def staged_ms(fn, iters: int = 10, warmup: int = 2) -> dict:
    """Median milliseconds of each stage of ``fn(timer)``: ``timer(label)``
    records a CUDA event after the stage's launches, and a stage's time is
    the device time from the previous event to its own."""
    import torch

    times: dict = {}
    for it in range(warmup + iters):
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()
        labels = []

        def timer(label):
            labels.append(label)
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

        fn(timer)
        torch.cuda.synchronize()
        if it >= warmup:
            for label, a, b in zip(labels, marks, marks[1:]):
                times.setdefault(label, []).append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def cuda_ms(fn, iters: int = 20, warmup: int = 3, batch: int = 5) -> float:
    """Median milliseconds of one ``fn()`` on the card: CUDA events around
    ``batch`` calls back to back, so the card's time, not the host's
    enqueue time, is what a short call measures."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def max_err(want, got) -> int:
    """Largest absolute difference over paired int64 tensors (exactness:
    must be 0)."""
    import torch

    torch.cuda.synchronize()
    return max(int((a - b).abs().max()) if a.numel() else 0
               for a, b in zip(want, got))


# A run_job in its own process, killed by the smoke once its first
# snapshot has landed: argv = repo root, checkpoint path, corpus files.
CRASH_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from mapreduce_tpu_torch import Config
from mapreduce_tpu_torch.models.wordcount import WordCountJob
from mapreduce_tpu_torch.runtime.executor import run_job
cfg = Config()
run_job(WordCountJob(cfg), sys.argv[3:], cfg, checkpoint_path=sys.argv[2],
        checkpoint_every=8)
"""


# The executor's phase spans (``obs/spans.py``), as named in a profile.
SPANS = ("read_wait", "stage", "dispatch", "host_read", "retire_wait",
         "h2d_tail", "compute_tail", "checkpoint", "reduce", "recover")


def idle_gaps(prof) -> dict:
    """The card's busy share and idle gaps in a profile: the union of every
    device event's interval, its share of the device span, and the gaps
    that follow a device-to-host copy (the chunk's host read; the recovery
    copies come after the stream)."""
    from torch.autograd import DeviceType

    # The profiler mirrors each record_function span onto the device
    # timeline as a user annotation over the kernels it launched: leave
    # those out, they are not device work.
    dev = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in SPANS
                  and e.time_range.end > e.time_range.start),
                 key=lambda r: r[0])
    if not dev:
        raise SystemExit("the profile holds no device events")
    busy, gaps, after_read = 0.0, [], []
    cur_s, cur_e, cur_name = dev[0]
    for start, end, name in dev[1:]:
        if start > cur_e:
            busy += cur_e - cur_s
            gaps.append(start - cur_e)
            if "DtoH" in cur_name:
                after_read.append(start - cur_e)
            cur_s, cur_e, cur_name = start, end, name
        elif end > cur_e:
            cur_e, cur_name = end, name
    busy += cur_e - cur_s
    span_us = cur_e - dev[0][0]
    return {"device_span_ms": span_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / span_us, "gaps": len(gaps),
            "gap_ms_total": sum(gaps) / 1e3,
            "gap_ms_top": sorted((round(g / 1e3, 3) for g in gaps),
                                 reverse=True)[:8],
            "gaps_after_host_read": len(after_read),
            "gap_ms_after_host_read_total": sum(after_read) / 1e3,
            "gap_ms_after_host_read_median":
                statistics.median(after_read) / 1e3 if after_read else None}


def stream_pipeline(drive, tmp: Path, path: Path, stream_data: bytes,
                    want_stream: dict, chunk32: bytes, dev) -> None:
    """Phase 6: the pipelined executor over the phase-4 file passed 8 times
    (see the module docstring)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mapreduce_tpu_torch import Config, count_file, native
    from mapreduce_tpu_torch.runtime import checkpoint as ckpt_mod

    cfg = Config()
    serial = Config(inflight_groups=1, prefetch_depth=1)
    corpus = [str(path)] * 8
    n_bytes = 8 * len(stream_data)
    per_file = -(-len(stream_data) // cfg.chunk_bytes)
    want = {w: 8 * c for w, c in want_stream.items()}
    if native.token_count(np.frombuffer(stream_data, np.uint8)) \
            != sum(want_stream.values()):
        raise SystemExit("the native chunker's token count differs from "
                         "the oracle's")
    # The reader fills every chunk through the native chunker (it has no
    # other fill): count its calls in each timed run, one a chunk.
    fills: list = []
    real_fill = native.fill_batch

    def counted_fill(*args):
        fills.append(1)
        return real_fill(*args)

    native.fill_batch = counted_fill
    try:
        for turn in range(3):
            for name, c in (("run_job", cfg), ("run_job_serial", serial)):
                fills.clear()
                got, seconds = drive(name, lambda c=c: count_file(corpus, c),
                                     want, {"tokenize_compact": 8 * per_file})
                if len(fills) != 8 * per_file:
                    raise SystemExit(f"{name} filled {len(fills)} chunks "
                                     f"with the native chunker, not "
                                     f"{8 * per_file}")
                run = got.run
                emit("stream_pipeline", run=name, turn=turn, bytes=n_bytes,
                     chunks=run.bases.shape[0], seconds=round(seconds, 4),
                     gb_per_s=n_bytes / seconds / 1e9,
                     run_job_gb_per_s=run.metrics.gb_per_s,
                     phases=run.metrics.phases, pipeline=run.pipeline,
                     overlap_fraction=run.pipeline["overlap_fraction"],
                     h2d_ms_per_chunk=run.pipeline["h2d_ms_per_chunk"],
                     native_fills=len(fills), equal_to_expected=True)
    finally:
        native.fill_batch = real_fill

    # One 32 MB chunk to the card from pageable and from pinned memory:
    # host clock around a synchronised copy, median of 10.
    host = np.frombuffer(chunk32, np.uint8).copy()
    pinned = torch.empty(host.shape[0], dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[:] = host
    target = torch.empty(host.shape[0], dtype=torch.uint8, device=dev)
    h2d = {}
    for name, src in (("pageable", torch.from_numpy(host)),
                      ("pinned", pinned)):
        times = []
        for _ in range(12):
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            target.copy_(src, non_blocking=name == "pinned")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t_a) * 1e3)
        h2d[name] = statistics.median(times[2:])
    if not torch.equal(target.cpu(), torch.from_numpy(host)):
        raise SystemExit("the pinned H2D copy differs from its source")
    emit("stream_pipeline", h2d_chunk_bytes=host.shape[0],
         pageable_h2d_ms=h2d["pageable"], pinned_h2d_ms=h2d["pinned"],
         pinned_gb_per_s=host.shape[0] / h2d["pinned"] / 1e6)
    del pinned, target

    # Where the card idles while streaming: a profile of two of the files,
    # beside the same run unprofiled (the profiler slows the host).
    torch.cuda.synchronize()
    t_a = time.perf_counter()
    count_file(corpus[:2], cfg)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t_a) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_a = time.perf_counter()
        got = count_file(corpus[:2], cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_a) * 1e3
    if got.as_dict() != {w: 2 * c for w, c in want_stream.items()}:
        raise SystemExit("the profiled streamed run differs from the oracle")
    spans = {e.key: {"ms": round(e.cpu_time_total / 1e3, 3),
                     "count": e.count}
             for e in prof.key_averages()
             if e.key in SPANS and e.device_type == DeviceType.CPU}
    gaps = idle_gaps(prof)
    emit("stream_pipeline", profile="count_file", files=2,
         chunks=got.run.bases.shape[0], profiled_wall_ms=wall_ms,
         unprofiled_wall_ms=plain_wall_ms, **gaps,
         device_busy_share_of_unprofiled_wall=gaps["device_busy_ms"]
         / plain_wall_ms, spans=spans)

    # Crash and resume: a subprocess streams with a snapshot every 8 steps
    # and is killed with SIGKILL once its first snapshot has landed.
    ck = tmp / "crash.npz"
    log = tmp / "crash.log"
    with open(log, "wb") as err:
        child = subprocess.Popen([sys.executable, "-c", CRASH_CHILD,
                                  str(ROOT), str(ck), *corpus],
                                 stdout=subprocess.DEVNULL, stderr=err)
        try:
            deadline = time.monotonic() + 600
            while child.poll() is None and time.monotonic() < deadline:
                if os.path.exists(ckpt_mod.integrity_path(str(ck))):
                    child.kill()
                    break
                time.sleep(0.002)
        finally:
            if child.poll() is None:
                child.kill()
            child.wait()
    if child.returncode != -9:
        raise SystemExit(f"the crash run was not killed mid-stream (exit "
                         f"{child.returncode}):\n"
                         + log.read_text(errors="replace")[-3000:])
    _, step, offset, _, _ = ckpt_mod.load(str(ck))
    got, seconds = drive("run_job_resumed", lambda: count_file(
        corpus, cfg, checkpoint_path=str(ck), checkpoint_every=8), want,
        {"tokenize_compact": 8 * per_file - step})
    emit("stream_pipeline", crash="SIGKILL", resumed_from_step=step,
         resumed_from_offset=offset, resumed_chunks=8 * per_file - step,
         seconds=round(seconds, 4),
         bytes_after_resume=got.run.metrics.bytes_processed,
         equal_to_expected=True)


# A streamed run killed at the process-kill seam: argv = repo root, corpus
# file, checkpoint path, in-flight groups.
KILL_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from mapreduce_tpu_torch import Config, count_file
cfg = Config(inflight_groups=int(sys.argv[4]),
             fault_plan="at=process-kill:2:transient")
count_file(sys.argv[2], cfg, checkpoint_path=sys.argv[3], checkpoint_every=1)
"""

# A streamed run with the caching allocator capped to a sliver of the card:
# argv = repo root, corpus file, memory fraction.  Prints one JSON line.
OOM_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from chip_smoke import result_digest
from mapreduce_tpu_torch import Config, count_file
from mapreduce_tpu_torch.runtime import faults
torch.cuda.set_per_process_memory_fraction(float(sys.argv[3]))
cfg = Config(map_impl="fused", combiner="hot-cache", sort_impl="radix",
             failure_policy={"transient_retries": 1, "resource_retries": 1,
                             "backoff_base_s": 0.0})
try:
    r = count_file(sys.argv[2], cfg)
    out = {"outcome": "done", "pipeline": r.run.pipeline,
           "digest": result_digest(r.words, r.counts)}
except Exception as e:
    out = {"outcome": "failed", "fault_class": faults.classify(e),
           "error": repr(e)[:400]}
print(json.dumps(out), flush=True)
"""

# The cost of replayability in a fresh process: argv = repo root, corpus
# file (passed 8 times), corpus bytes, the oracle's digest and total.
# One JSON line a run, after a warm-up run.
RETRY_COST_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from chip_smoke import result_digest
from mapreduce_tpu_torch import Config, count_file
from mapreduce_tpu_torch.ops.cuda import tokenize as ktok
corpus, n_bytes = [sys.argv[2]] * 8, int(sys.argv[3])
count_file(corpus, Config())
for turn in range(1):
    for retry in (0, 1, 1, 0):
        torch.cuda.synchronize()
        ktok.LAUNCHES.clear()
        t = time.perf_counter()
        got = count_file(corpus, Config(), retry=retry)
        seconds = time.perf_counter() - t
        print(json.dumps({
            "retry": retry, "turn": turn, "seconds": round(seconds, 4),
            "gb_per_s": n_bytes / seconds / 1e9,
            "run_job_gb_per_s": got.run.metrics.gb_per_s,
            "pinned_buffers": got.run.pipeline["pinned_buffers"],
            "full_retires": got.run.pipeline["full_retires"],
            "launches": dict(ktok.LAUNCHES),
            "equal_to_oracle": result_digest(got.words, got.counts)
            == sys.argv[4] and got.total == int(sys.argv[5])}), flush=True)
"""


def result_digest(words, counts) -> str:
    """A result's words and counts, in order, as one SHA-256."""
    import hashlib

    text = "".join(f"{w!r}\t{c}\n" for w, c in zip(words, counts))
    return hashlib.sha256(text.encode()).hexdigest()


def faults_phase(drive, tmp: Path, path: Path, stream_data: bytes,
                 want_stream: dict) -> None:
    """Phase 7: the failure policy, fault plans and preemption of the
    streamed executor (see the module docstring)."""
    import contextlib
    import dataclasses
    import io
    import logging
    import signal

    import torch

    from mapreduce_tpu_torch import Config, cli, count_file
    from mapreduce_tpu_torch.models import wordcount as wc
    from mapreduce_tpu_torch.ops.cuda import radix
    from mapreduce_tpu_torch.ops.cuda import tokenize as ktok
    from mapreduce_tpu_torch.runtime import checkpoint as ckpt_mod
    from mapreduce_tpu_torch.runtime import executor, faults
    from mapreduce_tpu_torch.runtime.logging import LOGGER_NAME

    chunks = -(-len(stream_data) // Config().chunk_bytes)
    need = {"tokenize_compact": None}
    # The plans the runs build, captured as they are resolved.
    plans: list = []
    real_resolve = faults.FaultPlan.resolve.__func__

    def resolve(cls, spec):
        plan = real_resolve(cls, spec)
        if plan is not None:
            plans.append(plan)
        return plan

    def fired():
        return [(f["seam"], f["index"], f["fault_class"])
                for f in plans[-1].fired] if plans else []

    def fresh_ck(name: str) -> str:
        ck = str(tmp / f"{name}.npz")
        for p in (ck, ckpt_mod.integrity_path(ck), ckpt_mod.previous_path(ck),
                  ckpt_mod.integrity_path(ckpt_mod.previous_path(ck))):
            if os.path.exists(p):
                os.unlink(p)
        return ck

    def ms(got, phase):
        return round(got.run.metrics.phases.get(phase, 0.0) * 1e3, 3)

    corpus8 = [str(path)] * 8
    want8 = {w: 8 * c for w, c in want_stream.items()}
    n_bytes = 8 * len(stream_data)

    def retry0_rate(name: str) -> float:
        """The GB/s of one retry=0 run in this process."""
        rates = []
        for turn in range(1):
            got, seconds = drive(name, lambda: count_file(corpus8, Config()),
                                 want8, {"tokenize_compact": 8 * chunks})
            rates.append(n_bytes / seconds / 1e9)
            emit("faults", case="retry_cost", run=name, retry=0, turn=turn,
                 gb_per_s=rates[-1],
                 run_job_gb_per_s=got.run.metrics.gb_per_s,
                 seconds=round(seconds, 4))
        return statistics.median(rates)

    # 7. the cost of replayability: retry=0 against retry=1, in turns 0, 1,
    # 1, 0, in a fresh process, so that nothing an earlier phase left in
    # this one weighs on it; beside it, one retry=0 run here now and one
    # after every other case (what those phases leave behind).
    here_before = retry0_rate("faults_retry0_after_phase6")
    child = subprocess.run(
        [sys.executable, "-c", RETRY_COST_CHILD, str(ROOT), str(path),
         str(n_bytes), result_digest(list(want8), list(want8.values())),
         str(sum(want8.values()))],
        capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        raise SystemExit(f"the retry-cost child exited {child.returncode}:\n"
                         f"{child.stderr[-3000:]}")
    rates: dict = {0: [], 1: []}
    for line in child.stdout.strip().splitlines():
        run = json.loads(line)
        if not run["equal_to_oracle"] or run["launches"].get(
                "tokenize_compact") != 8 * chunks:
            raise SystemExit(f"the retry-cost child's run {run}")
        rates[run["retry"]].append(run["gb_per_s"])
        emit("faults", case="retry_cost", run="fresh_process", **run)
    if [len(v) for v in rates.values()] != [2, 2]:
        raise SystemExit(f"the retry-cost child ran {rates}")
    emit("faults", case="retry_cost",
         median_gb_per_s={r: statistics.median(v) for r, v in rates.items()},
         retry1_over_retry0=statistics.median(rates[1])
         / statistics.median(rates[0]),
         here_retry0_median_gb_per_s=here_before)

    faults.FaultPlan.resolve = classmethod(resolve)
    try:
        # 1. one transient fault at each seam, window 4 and window 1
        seams = {"reader-read": 1, "stage-acquire": 1, "h2d": 1,
                 "dispatch": 1, "token-wait": 1, "checkpoint-save": 0,
                 "collective-finish": 0}
        for window in (4, 1):
            for seam, index in seams.items():
                cfg = Config(inflight_groups=window,
                             fault_plan=f"at={seam}:{index}:transient")
                kw = {"retry": 2}
                if seam == "checkpoint-save":
                    kw.update(checkpoint_path=fresh_ck("seam"),
                              checkpoint_every=2)
                name = f"faults_{seam}_w{window}"
                got, seconds = drive(name, lambda: count_file(
                    str(path), cfg, **kw), want_stream, need)
                if fired() != [(seam, index, "transient")]:
                    raise SystemExit(f"{name} fired {fired()}")
                emit("faults", case="seam", seam=seam, window=window,
                     fired=fired(), recoveries=got.run.pipeline.get(
                         "recoveries", 0), replay_ms=ms(got, "replay"),
                     seconds=round(seconds, 4), equal_to_oracle=True)
            # process-kill: the child exits 113 between groups, after the
            # snapshot of the group before; the resume here is exact.
            ck = fresh_ck("kill")
            child = subprocess.run(
                [sys.executable, "-c", KILL_CHILD, str(ROOT), str(path), ck,
                 str(window)], capture_output=True, text=True, timeout=600)
            if child.returncode != 113:
                raise SystemExit(f"the process-kill child exited "
                                 f"{child.returncode}:\n{child.stderr[-3000:]}")
            _, step, offset, _, _ = ckpt_mod.load(ck)
            got, seconds = drive(f"faults_process-kill_w{window}_resumed",
                                 lambda: count_file(str(path), Config(),
                                                    checkpoint_path=ck),
                                 want_stream,
                                 {"tokenize_compact": chunks - step})
            emit("faults", case="seam", seam="process-kill", window=window,
                 child_exit=113, snapshot_step=step, snapshot_offset=offset,
                 resumed_seconds=round(seconds, 4), equal_to_oracle=True)

        # 2. a seeded random plan
        spec = "seed=7,rate=0.2,classes=transient+resource,max=6"
        got, seconds = drive("faults_random_plan", lambda: count_file(
            str(path), Config(fault_plan=spec), retry=3,
            checkpoint_path=fresh_ck("random"), checkpoint_every=2),
            want_stream, need)
        if not fired():
            raise SystemExit("the random plan fired nothing")
        emit("faults", case="random_plan", spec=spec, fired=fired(),
             recoveries=got.run.pipeline.get("recoveries", 0),
             degrade_steps=got.run.pipeline.get("degrade_steps", []),
             replay_ms=ms(got, "replay"), seconds=round(seconds, 4),
             equal_to_oracle=True)

        # 3. the ladder: every second dispatch crossing of a pair fails, so
        # each failed group's replay fails once more and steps down a rung;
        # window 1, so the rung runs the group before the next pair.
        storm = ",".join(f"at=dispatch:{i}:resource" for i in (1, 2, 4, 5,
                                                                7, 8))
        ladder_policy = {"transient_retries": 1, "resource_retries": 0,
                         "backoff_base_s": 0.0}
        rungs: list = []

        class Rung(logging.Handler):
            def emit(self, record):
                if record.getMessage() == "degradation ladder step":
                    rungs.append((record.fields["ladder_step"],
                                  {**ktok.LAUNCHES, **radix.LAUNCHES}))

        handler = Rung()
        logging.getLogger(LOGGER_NAME).addHandler(handler)
        try:
            start = Config(inflight_groups=1, map_impl="fused",
                           combiner="hot-cache", sort_impl="radix",
                           fault_plan=storm, failure_policy=ladder_policy)
            got, seconds = drive("faults_ladder", lambda: count_file(
                str(path), start), want_stream,
                {"tokenize_combiner": None, "tokenize_fused": None,
                 "tokenize_compact": None, "radix_partition": None,
                 "radix_sort": None})
        finally:
            logging.getLogger(LOGGER_NAME).removeHandler(handler)
        steps = got.run.pipeline.get("degrade_steps")
        if steps != ["combiner-off", "map-split", "sort-xla"] \
                or [r[0] for r in rungs] != steps:
            raise SystemExit(f"the ladder walked {steps}")
        marks = [("start", {})] + rungs \
            + [("end", {**ktok.LAUNCHES, **radix.LAUNCHES})]
        per_rung = {}
        for (name, before), (_, after) in zip(marks, marks[1:]):
            per_rung[name] = {k: v - before.get(k, 0)
                              for k, v in after.items() if v > before.get(k, 0)}
        expect = {"start": ("tokenize_combiner", "radix_partition"),
                  "combiner-off": ("tokenize_fused", "radix_partition"),
                  "map-split": ("tokenize_compact", "radix_partition"),
                  "sort-xla": ("tokenize_compact",)}
        for rung, kernels in expect.items():
            if not all(per_rung.get(rung, {}).get(k) for k in kernels):
                raise SystemExit(f"ladder rung {rung} launched "
                                 f"{per_rung.get(rung)}")
        if per_rung["sort-xla"].get("radix_partition"):
            raise SystemExit("the sort-xla rung launched the radix seam")
        emit("faults", case="ladder", storm=storm, window=1,
             degrade_steps=steps, launches_per_rung=per_rung, fired=fired(),
             replay_ms=ms(got, "replay"), seconds=round(seconds, 4),
             equal_to_oracle=True)
        exhausted = Config(fault_plan="at=dispatch:1:resource,"
                                      "at=dispatch:2:resource",
                           failure_policy=ladder_policy)
        try:
            count_file(str(path), exhausted)
        except faults.ResourceFault as e:
            cls = faults.classify(e)
        else:
            raise SystemExit("the exhausted ladder did not fail")
        if cls != "resource":
            raise SystemExit(f"the exhausted ladder failed as {cls}")
        emit("faults", case="ladder_exhausted", fault_class=cls,
             fired=fired())

        # 4. a real late completion at window 4: a sleep queued on the
        # compute stream before a step's map, so that the map's host read
        # (and, behind it, every wait of the window) passes a
        # token_timeout_s of 0.2 s.  A late kernel (0.6 s, first step)
        # must replay exactly; a hung one (6 s, third step, longer than
        # every wait of the budget together) must end the run with a
        # TokenTimeout while it still runs.
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        torch.cuda._sleep(100_000_000)
        end_ev.record()
        end_ev.synchronize()
        cycles_per_ms = 100_000_000 / start_ev.elapsed_time(end_ev)
        late = Config(failure_policy={
            "transient_retries": 3, "token_timeout_s": 0.2,
            "backoff_base_s": 0.0})

        def late_run(sleep_ms: int, at_step: int):
            job = wc.WordCountJob(late)
            real_map = job.map_chunk
            slept = []

            def slow_map(chunk, chunk_id):
                if chunk_id == at_step and not slept:
                    torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
                    slept.append(chunk_id)
                return real_map(chunk, chunk_id)

            job.map_chunk = slow_map
            rr = executor.run_job(job, str(path), late)
            res = executor.recover_from_file(rr.value, str(path), rr.bases)
            return dataclasses.replace(res, run=rr)

        got, seconds = drive("faults_late_wait", lambda: late_run(600, 0),
                             want_stream, need)
        if not got.run.pipeline.get("recoveries"):
            raise SystemExit("the late completion was not replayed")
        emit("faults", case="late_wait", window=late.inflight_groups,
             sleep_ms=600, at_step=0, token_timeout_s=0.2,
             recoveries=got.run.pipeline["recoveries"],
             replay_ms=ms(got, "replay"), seconds=round(seconds, 4),
             equal_to_oracle=True)
        hang_ms = 6000
        t_a = time.perf_counter()
        try:
            late_run(hang_ms, 2)
        except faults.TokenTimeout as e:
            cls = faults.classify(e)
        else:
            raise SystemExit("the hung kernel's run did not time out")
        seconds = time.perf_counter() - t_a
        torch.cuda.synchronize()  # the hung kernel ends here
        if seconds >= hang_ms / 2e3 or cls != "transient":
            raise SystemExit(f"the hung kernel's run ended after {seconds} s "
                             f"as {cls}")
        emit("faults", case="hung_kernel", window=late.inflight_groups,
             sleep_ms=hang_ms, at_step=2, token_timeout_s=0.2,
             error="TokenTimeout", fault_class=cls,
             seconds_to_fail=round(seconds, 4))
    finally:
        faults.FaultPlan.resolve = classmethod(real_resolve)

    # 5. a real CUDA out-of-memory: a child whose allocator may hold 256 MB
    frac = (256 << 20) / torch.cuda.get_device_properties(0).total_memory
    child = subprocess.run([sys.executable, "-c", OOM_CHILD, str(ROOT),
                            str(path), repr(frac)], capture_output=True,
                           text=True, timeout=600)
    if child.returncode != 0:
        raise SystemExit(f"the out-of-memory child exited "
                         f"{child.returncode}:\n{child.stderr[-3000:]}")
    oom = json.loads(child.stdout.strip().splitlines()[-1])
    classes = sorted({tok.split("=", 1)[1] for line in child.stderr.splitlines()
                      for tok in line.split() if tok.startswith("fault_class=")})
    want_digest = result_digest(list(want_stream), list(want_stream.values()))
    if oom["outcome"] == "done":
        if oom["digest"] != want_digest:
            raise SystemExit("the out-of-memory run differs from the oracle")
    elif oom["fault_class"] != "resource":
        raise SystemExit(f"the out-of-memory run failed as {oom}")
    if classes != ["resource"]:
        raise SystemExit(f"the out-of-memory run saw classes {classes}")
    emit("faults", case="out_of_memory", memory_fraction=frac,
         cap_bytes=256 << 20, classes_seen=classes, **oom)

    # 6. preemption: SIGINT to the CLI once its first snapshot landed
    for extra in ([], ["--top-k", "5"]):
        argv = [*corpus8, "--stream", "--no-echo", "--format", "json", *extra]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if cli.main(argv) != 0:
                raise SystemExit("the uninterrupted CLI run failed")
        want_out = buf.getvalue().encode()
        ck = fresh_ck("preempt")
        cmd = [sys.executable, "-m", "mapreduce_tpu_torch", *argv,
               "--checkpoint", ck, "--checkpoint-every", "2"]
        with open(tmp / "preempt.log", "wb") as err:
            child = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=err)
            try:
                deadline = time.monotonic() + 600
                while child.poll() is None and time.monotonic() < deadline:
                    if os.path.exists(ckpt_mod.integrity_path(ck)):
                        child.send_signal(signal.SIGINT)
                        break
                    time.sleep(0.002)
                out, _ = child.communicate(timeout=600)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
        log = (tmp / "preempt.log").read_text(errors="replace")
        if child.returncode != 75 or out:
            raise SystemExit(f"the interrupted CLI exited {child.returncode} "
                             f"(stdout {len(out)} bytes):\n{log[-3000:]}")
        _, step, offset, _, _ = ckpt_mod.load(ck)
        relaunch = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  timeout=600)
        if relaunch.returncode != 0 or relaunch.stdout != want_out:
            (tmp / "want.out").write_bytes(want_out)
            (tmp / "got.out").write_bytes(relaunch.stdout)
            raise SystemExit(f"the relaunched CLI exited "
                             f"{relaunch.returncode}, stdout equal "
                             f"{relaunch.stdout == want_out}:\n"
                             + relaunch.stderr.decode(errors='replace')[-3000:])
        emit("faults", case="preemption", top_k=extra[1] if extra else None,
             signal="SIGINT", exit=75, snapshot_step=step,
             snapshot_offset=offset,
             preempted_line=[ln for ln in log.splitlines()
                             if ln.startswith("preempted:")],
             relaunch_stdout_bytes=len(relaunch.stdout),
             relaunch_equal_to_uninterrupted=True)

    here_after = retry0_rate("faults_retry0_after_cases")
    emit("faults", case="retry_cost_here",
         after_phase6_median_gb_per_s=here_before,
         after_cases_median_gb_per_s=here_after,
         after_over_before=here_after / here_before)


# The cost of telemetry in a fresh process: argv = repo root, corpus file
# (passed 8 times), corpus bytes, the oracle's digest and total, a scratch
# directory for the ledgers.  After a warm-up run, one JSON line a run, in
# turns off, registry (a handle without a ledger: data statistics and
# instruments), ledger (the full planes), ledger, registry, off, two
# turns, with each run's phases; then one line of the host microseconds of
# each part of a group's telemetry.
TELEMETRY_COST_CHILD = """
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from chip_smoke import result_digest
from mapreduce_tpu_torch import Config, count_file
from mapreduce_tpu_torch.obs import ledger, telemetry
from mapreduce_tpu_torch.ops import datastats
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.ops.cuda import tokenize as ktok
corpus, n_bytes = [sys.argv[2]] * 8, int(sys.argv[3])
count_file(corpus, Config())
for turn in range(2):
    for i, arm in enumerate(("off", "registry", "ledger", "ledger",
                             "registry", "off")):
        led = os.path.join(sys.argv[6], f"cost-{turn}-{i}.jsonl")
        tel = None if arm == "off" else telemetry.Telemetry.create(
            ledger_path=led if arm == "ledger" else None)
        torch.cuda.synchronize()
        ktok.LAUNCHES.clear()
        t = time.perf_counter()
        got = count_file(corpus, Config(), telemetry=tel)
        seconds = time.perf_counter() - t
        if tel is not None:
            tel.close()
        print(json.dumps({
            "arm": arm, "turn": turn, "seconds": round(seconds, 4),
            "gb_per_s": n_bytes / seconds / 1e9,
            "run_job_gb_per_s": got.run.metrics.gb_per_s,
            "phases": got.run.metrics.as_dict()["phases"],
            "ledger_bytes": os.path.getsize(led) if arm == "ledger" else 0,
            "launches": dict(ktok.LAUNCHES),
            "equal_to_oracle": result_digest(got.words, got.counts)
            == sys.argv[4] and got.total == int(sys.argv[5])}), flush=True)


def us(fn, n=2000):
    fn()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t) / n * 1e6


dev = torch.device("cuda")
rec = [{k: v for k, v in r.items() if k not in ("ts", "run_id")}
       for r in ledger.read_ledger(os.path.join(sys.argv[6],
                                                "cost-0-2.jsonl"))
       if r["kind"] in ("step", "group")][:2]
bench = ledger.RunLedger(os.path.join(sys.argv[6], "bench.jsonl"), "bench")
tbl = table_ops.empty(Config().table_capacity, dev)
out = {
    "memory_allocated_and_max_us": us(lambda: (
        torch.cuda.memory_allocated(dev),
        torch.cuda.max_memory_allocated(dev))),
    "device_memory_stats_us": us(lambda: telemetry.device_memory_stats(dev)),
    "step_and_group_write_us": us(lambda: [bench.write(**r) for r in rec]),
    "gauges_and_fetch_us": us(lambda: datastats.StatsFetch(
        datastats.with_table_gauges(datastats.map_stats(), tbl)), 500),
}
torch.cuda.synchronize()
bench.close()
print(json.dumps({"attribution_us_per_group": out}), flush=True)
"""


def sync_calls(prof) -> dict:
    """The host's synchronising CUDA runtime calls in a profile."""
    names = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize")
    return {e.key: e.count for e in prof.key_averages() if e.key in names}


def telemetry_phase(drive, by_path: dict, branches: dict, tmp: Path,
                    path: Path, stream_data: bytes, want_stream: dict) -> None:
    """Phase 8: the run ledger, metrics registry, flight recorder,
    data-plane statistics and profiler of the streamed executor (see the
    module docstring)."""
    import contextlib
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mapreduce_tpu_torch import Config, cli, count_file
    from mapreduce_tpu_torch.models import wordcount as wc
    from mapreduce_tpu_torch.obs import ledger, registry, telemetry, timeline
    from mapreduce_tpu_torch.runtime import faults

    chunks = -(-len(stream_data) // Config().chunk_bytes)
    corpus8 = [str(path)] * 8
    want8 = {w: 8 * c for w, c in want_stream.items()}
    n_bytes = 8 * len(stream_data)

    def ledgered(name, fn, want, need, led):
        """``fn(tel)`` through ``drive`` with a fresh ledger at ``led``:
        ``(result, seconds, records)``."""
        if os.path.exists(led):
            os.unlink(led)
        tel = telemetry.Telemetry.create(ledger_path=led,
                                         registry=registry.MetricsRegistry())
        try:
            got, seconds = drive(name, lambda: fn(tel), want, need)
        finally:
            tel.close()
        return got, seconds, list(ledger.read_ledger(led))

    def check_groups(recs, n_steps):
        groups = [r for r in recs if r["kind"] == "group"]
        steps = sorted(s for g in groups
                       for s in range(g["step_first"], g["step_last"] + 1))
        if steps != list(range(n_steps)):
            raise SystemExit(f"group records cover steps {steps}")
        for g in groups:
            stamps = [g[k] for k in ("read_at", "staged_at", "dispatched_at",
                                     "token_ready_at", "retired_at")]
            if stamps != sorted(stamps):
                raise SystemExit(f"group stamps out of order: {g}")
        return groups

    # 1. a ledger'd Config() run over the 8-file corpus, and the timeline
    # of its own records beside its phase split
    led1 = str(tmp / "tel_run.jsonl")
    got, seconds, recs = ledgered(
        "telemetry_run_job", lambda tel: count_file(corpus8, Config(),
                                                    telemetry=tel),
        want8, {"tokenize_compact": 8 * chunks}, led1)
    kinds = [r["kind"] for r in recs]
    if kinds[0] != "run_start" or kinds[-3:] != ["collective", "data",
                                                 "run_end"] \
            or set(kinds[1:-3]) != {"step", "group", "progress"}:
        raise SystemExit(f"ledger kinds out of order: {kinds}")
    groups = check_groups(recs, 8 * chunks)
    if len(groups) != got.run.pipeline["dispatch_groups"]:
        raise SystemExit("not one group record per retired group")
    steps = [r for r in recs if r["kind"] == "step"]
    if not all(r["mem"].get("bytes_in_use", 0) > 0 for r in steps):
        raise SystemExit("a step record lacks the card's memory")
    depth = max(r["inflight_depth"] for r in steps)
    tl = timeline.reconstruct(recs)
    data = recs[-2]
    if data["tokens"] != sum(want8.values()) or data["chunks"] != 8 * chunks:
        raise SystemExit(f"the data record counts {data}")
    emit("telemetry", case="ledger_run", bytes=n_bytes,
         seconds=round(seconds, 4), gb_per_s=n_bytes / seconds / 1e9,
         records=len(recs), kinds={k: kinds.count(k) for k in set(kinds)},
         depth_max=depth, pipeline=got.run.pipeline,
         phases=got.run.metrics.phases,
         mem_bytes_in_use_max=max(r["mem"]["bytes_in_use"] for r in steps),
         compile_events=[r["compile_events"] for r in steps
                         if "compile_events" in r],
         timeline={"span_s": tl["span_s"], "lane_busy_s": tl["lane_busy_s"],
                   "exclusive_s": tl["exclusive_s"],
                   "device_idle_s": tl["device_idle"]["total_s"],
                   "device_idle_blocked_on": tl["device_idle"]["blocked_on"],
                   "bottleneck": tl["bottleneck"]},
         data={k: data[k] for k in ("tokens", "table_valid",
                                    "table_occupancy", "top_mass", "overlong",
                                    "rescued", "dropped_tokens")},
         equal_to_oracle=True)

    # 2. fused + hot-cache + radix over the 130 MB file with a pairs region
    # (its chunk takes the combiner-free rerun): the data record's combiner
    # counters are the run's branch counts
    comb = Config(map_impl="fused", combiner="hot-cache", sort_impl="radix")
    pairs_data = with_pairs(stream_data, 100 * MB)
    pairs_path = tmp / "tel_pairs.txt"
    pairs_path.write_bytes(pairs_data)
    want_pairs = word_counts(pairs_data)
    pairs_chunks = -(-len(pairs_data) // comb.chunk_bytes)
    got, seconds, recs = ledgered(
        "telemetry_combiner", lambda tel: count_file(str(pairs_path), comb,
                                                     telemetry=tel),
        want_pairs, {"tokenize_combiner": pairs_chunks, "tokenize_pair": 1,
                     "radix_partition": None, "radix_sort": None},
        str(tmp / "tel_combiner.jsonl"))
    data = [r for r in recs if r["kind"] == "data"][0]
    br = branches["telemetry_combiner"]
    counted = {"combiner_hits": br.get("combiner_hits", 0),
               "combiner_flushes": br.get("combiner_flushes", 0),
               "fallback_chunks": br.get("spill_fallbacks", 0)}
    if {k: data[k] for k in counted} != counted \
            or not data["combiner_hits"] or data["fallback_chunks"] != 1:
        raise SystemExit(f"data record {data} against branches {br}")
    emit("telemetry", case="combiner", bytes=len(pairs_data),
         seconds=round(seconds, 4), launches=by_path["telemetry_combiner"],
         branches=br, data={k: data[k] for k in (
             "combiner_hits", "combiner_flushes", "combiner_evicted",
             "combiner_hit_rate", "fallback_chunks", "spill_rows", "tokens")},
         equal_to_oracle=True)
    del pairs_data

    # 3. a chaotic ledger'd run, its ledger replayed as a plan, and an
    # absorbed ledger-append fault
    spec = "seed=7,rate=0.2,classes=transient+resource,max=6"
    need = {"tokenize_compact": None}
    got, seconds, chaos = ledgered(
        "telemetry_chaos", lambda tel: count_file(
            str(path), Config(fault_plan=spec), retry=2, telemetry=tel),
        want_stream, need, str(tmp / "tel_chaos.jsonl"))
    fired = faults.fired_sequence(chaos)
    replay = faults.FaultPlan.from_ledger(chaos)
    _, _, again = ledgered(
        "telemetry_chaos_replayed", lambda tel: count_file(
            str(path), Config(fault_plan=replay.spec), retry=2,
            telemetry=tel),
        want_stream, need, str(tmp / "tel_replay.jsonl"))
    if not fired or faults.fired_sequence(again) != fired:
        raise SystemExit(f"the replayed plan fired "
                         f"{faults.fired_sequence(again)}, not {fired}")
    _, _, absorbed = ledgered(
        "telemetry_ledger_append", lambda tel: count_file(
            str(path), Config(fault_plan="at=ledger-append:1:transient"),
            telemetry=tel),
        want_stream, need, str(tmp / "tel_append.jsonl"))
    n_steps = [r["kind"] for r in absorbed].count("step")
    if faults.fired_sequence(absorbed) != [("ledger-append", 1,
                                            "transient")] \
            or n_steps != chunks - 1:
        raise SystemExit(f"the ledger-append fault was not absorbed: "
                         f"{faults.fired_sequence(absorbed)}, {n_steps} steps")
    emit("telemetry", case="chaos", spec=spec, fired=fired,
         replayed_spec=replay.spec, replay_fired_equal=True,
         recoveries=got.run.pipeline.get("recoveries", 0),
         ledger_append_absorbed=True, step_records=n_steps,
         equal_to_oracle=True)

    # 4. a failed run through the CLI: a failure record and a flight dump
    # whose context names the step
    led4 = str(tmp / "tel_failed.jsonl")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main([str(path), "--stream", "--no-echo", "--ledger", led4,
                      "--fault-plan", "at=dispatch:2:permanent"])
    except faults.PermanentFault:
        pass
    else:
        raise SystemExit("the permanent fault did not fail the run")
    last = list(ledger.read_ledger(led4))[-1]
    with open(led4 + ".flight.json") as f:
        dump = json.load(f)
    if last["kind"] != "failure" or dump["context"]["step"] != last["step"] \
            or last["flight_dump"] != led4 + ".flight.json":
        raise SystemExit(f"failure record {last}, dump {dump['context']}")
    emit("telemetry", case="failed_run", failure=last,
         flight_context=dump["context"], flight_events=dump["events_kept"])

    # 5. the CLI on the card with --ledger, --metrics-out and --profile
    led5, met5, prof5 = (str(tmp / n) for n in ("cli.jsonl", "cli.json",
                                                 "cli_profile"))
    base = [sys.executable, "-m", "mapreduce_tpu_torch", str(path),
            "--stream", "--no-echo", "--format", "json"]
    plain = subprocess.run(base, cwd=ROOT, capture_output=True, timeout=600)
    told = subprocess.run(base + ["--ledger", led5, "--metrics-out", met5,
                                  "--profile", prof5], cwd=ROOT,
                          capture_output=True, timeout=600)
    if plain.returncode or told.returncode or plain.stdout != told.stdout:
        raise SystemExit(f"the telemetered CLI exited {told.returncode} "
                         f"(plain {plain.returncode}), stdout equal "
                         f"{plain.stdout == told.stdout}:\n"
                         + told.stderr.decode(errors="replace")[-3000:])
    n_groups = [r["kind"] for r in ledger.read_ledger(led5)].count("group")
    with open(met5) as f:
        metrics = json.load(f)
    if metrics["counters"]["executor.groups_retired"] != n_groups:
        raise SystemExit(f"metrics {metrics['counters']} against {n_groups} "
                         "group records")
    traces = list(Path(prof5).glob("*.json"))
    names = {e.get("name", "") for t in traces
             for e in json.loads(t.read_text())["traceEvents"]}
    spans = {"read_wait", "stage", "dispatch", "host_read", "retire_wait"}
    kernel = sorted(n for n in names if "tokenize_stream" in n)
    if len(traces) != 1 or not spans <= names or not kernel:
        raise SystemExit(f"the profile {traces} lacks spans "
                         f"{spans - names} or the kernel ({kernel})")
    emit("telemetry", case="cli", exit=0, stdout_equal=True,
         group_records=n_groups,
         groups_retired=metrics["counters"]["executor.groups_retired"],
         trace_events=len(names), kernel_events=kernel[:3],
         profile_bytes=traces[0].stat().st_size)

    # The syncs of a telemetered run: a profile of two files with and
    # without telemetry counts the host's synchronising runtime calls.
    syncs = {}
    for on in (False, True):
        tel = telemetry.Telemetry.create(
            ledger_path=str(tmp / "tel_sync.jsonl")) if on else None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = count_file(corpus8[:2], Config(), telemetry=tel)
            torch.cuda.synchronize()
        if tel is not None:
            tel.close()
        if got.as_dict() != {w: 2 * c for w, c in want_stream.items()}:
            raise SystemExit("a profiled run differs from the oracle")
        syncs["on" if on else "off"] = sync_calls(prof)
    if any(n > syncs["off"].get(k, 0) for k, n in syncs["on"].items()):
        raise SystemExit(f"telemetry adds syncs: {syncs}")
    emit("telemetry", case="syncs", files=2, sync_calls=syncs)

    # 6. the cost of telemetry (ledger + registry), in turns off,
    # registry, ledger, ledger, registry, off, two turns, in a fresh
    # process
    child = subprocess.run(
        [sys.executable, "-c", TELEMETRY_COST_CHILD, str(ROOT), str(path),
         str(n_bytes), result_digest(list(want8), list(want8.values())),
         str(sum(want8.values())), str(tmp)],
        capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        raise SystemExit(f"the telemetry-cost child exited "
                         f"{child.returncode}:\n{child.stderr[-3000:]}")
    rates: dict = {"off": [], "registry": [], "ledger": []}
    ledger_bytes = []
    *runs, attribution = child.stdout.strip().splitlines()
    for line in runs:
        run = json.loads(line)
        if not run["equal_to_oracle"] or run["launches"].get(
                "tokenize_compact") != 8 * chunks:
            raise SystemExit(f"the telemetry-cost child's run {run}")
        rates[run["arm"]].append(run["gb_per_s"])
        if run["arm"] == "ledger":
            ledger_bytes.append(run["ledger_bytes"])
        emit("telemetry", case="cost", run="fresh_process", **run)
    if [len(v) for v in rates.values()] != [4, 4, 4]:
        raise SystemExit(f"the telemetry-cost child ran {rates}")
    med = {arm: statistics.median(v) for arm, v in rates.items()}
    emit("telemetry", case="cost", median_gb_per_s=med,
         on_over_off=med["ledger"] / med["off"],
         registry_over_off=med["registry"] / med["off"],
         ledger_bytes=statistics.median(ledger_bytes),
         **json.loads(attribution))


# The gram and sketch oracles of phase 9: token spans by numpy, token keys
# by the port's host mirror ``ops/sketch.py:hash_word`` (pure Python, not
# the device code), gram keys folded here in numpy with the composition
# the port documents (``ops/tokenize.py:mix_gram``).
SEPARATORS = (0x00, 0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20)
HASH_BASE_1, HASH_BASE_2 = 16777619, 2654435761
FMIX_C1, FMIX_C2, SENT = 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF
HLL_P, CMS_DEPTH, CMS_WIDTH = 14, 4, 1 << 16
CMS_SALTS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)


def card_name() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, to
    print beside a time."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"


def word_counts(data: bytes) -> dict:
    """The oracle's insertion-ordered counts
    (``mapreduce_tpu_torch/utils/oracle.py:word_counts``, a byte loop in
    Python) by ``bytes.split``, which splits on the same separators but
    NUL: without a NUL byte in ``data`` the two give the same dict, and
    the smoke holds them equal on a slice of each corpus it counts."""
    import collections

    from mapreduce_tpu_torch.utils import oracle

    if b"\x00" in data:
        return oracle.word_counts(data)
    probe = data[:MB].rpartition(b" ")[0]
    if dict(collections.Counter(probe.split())) != oracle.word_counts(probe):
        raise SystemExit("bytes.split counts differ from the oracle's")
    return dict(collections.Counter(data.split()))


def token_spans(data: bytes):
    """``(starts, ends)``: every token's span, by numpy."""
    import numpy as np

    arr = np.frombuffer(data, np.uint8)
    lut = np.zeros(256, bool)
    lut[list(SEPARATORS)] = True
    sep = lut[arr]
    starts = np.flatnonzero(~sep & np.concatenate([[True], sep[:-1]]))
    ends = np.flatnonzero(~sep & np.concatenate([sep[1:], [True]])) + 1
    return starts, ends


def host_tokens(data: bytes):
    """``(starts, ends, ids, vocab)``: every token's span, its id in order
    of first appearance, and the distinct tokens in that order."""
    import numpy as np

    starts, ends = token_spans(data)
    if b"\x00" in data:  # a separator ``bytes.split`` does not know
        toks = [data[a:b] for a, b in zip(starts.tolist(), ends.tolist())]
    else:
        toks = data.split()
    vocab = list(dict.fromkeys(toks))  # first-appearance order
    index = {t: i for i, t in enumerate(vocab)}
    ids = np.fromiter(map(index.__getitem__, toks), np.int64,
                      count=len(toks))
    if len(toks) != len(starts):
        raise SystemExit("bytes.split and the token spans disagree")
    return starts, ends, ids, vocab


def _fmix32(x):
    import numpy as np

    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(FMIX_C1)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(FMIX_C2)
    return x ^ (x >> np.uint32(16))


def _mix(p_hi, p_lo, k_hi, k_lo):
    """One gram extension: ``fmix32(prev * B ^ key)`` a lane, clamped off
    the two reserved keys."""
    import numpy as np

    with np.errstate(over="ignore"):
        g_hi = _fmix32((p_hi * np.uint32(HASH_BASE_1)) ^ k_hi)
        g_lo = _fmix32((p_lo * np.uint32(HASH_BASE_2)) ^ k_lo)
    return g_hi, np.where((g_hi == SENT) & (g_lo >= SENT - 1),
                          np.uint32(SENT - 2), g_lo).astype(np.uint32)


def token_keys(vocab) -> tuple:
    """uint32 ``(key_hi, key_lo)`` of each token, by ``hash_word``."""
    import numpy as np

    from mapreduce_tpu_torch.ops.sketch import hash_word

    keys = np.array([hash_word(t) for t in vocab], dtype=np.uint64)
    return keys[:, 0].astype(np.uint32), keys[:, 1].astype(np.uint32)


def gram_oracle(data: bytes, tokens, n: int, w: int | None, capacity: int):
    """What a run over ``data`` must report with a table of ``capacity``:
    the n-token windows (n = 1: the words), minus those holding a token
    longer than ``w`` (the kernel path drops them; None: none), grouped by
    token sequence; past capacity the table keeps the ``capacity`` smallest
    64-bit keys, each with its exact count (a key among the smallest
    overall is among the smallest of every chunk).  Returns ``(want,
    total, dropped_count, distinct, keys)``: ``want`` the kept ``{first
    span: count}`` in first-occurrence order; ``keys`` the uint32 keys and
    counts of every distinct window, for the sketches."""
    import numpy as np

    starts, ends, ids, vocab = tokens
    m = len(ids) - n + 1
    if m <= 0:
        return {}, 0, 0, 0, None
    t_hi, t_lo = token_keys(vocab)
    bad = np.zeros(m, bool)
    if w is not None:
        long = (ends - starts) > w
        for j in range(n):
            bad |= long[j:j + m]
    code = np.zeros(m, np.int64)
    for j in range(n):
        code = code * len(vocab) + ids[j:j + m]
    good = np.flatnonzero(~bad)
    _, first, counts = np.unique(code[good], return_index=True,
                                 return_counts=True)
    g0 = good[first]  # each distinct window's first occurrence
    g_hi, g_lo = t_hi[ids[g0]], t_lo[ids[g0]]
    for j in range(1, n):
        g_hi, g_lo = _mix(g_hi, g_lo, t_hi[ids[g0 + j]], t_lo[ids[g0 + j]])
    kept = np.arange(len(g0))
    if len(g0) > capacity:
        key64 = (g_hi.astype(np.uint64) << np.uint64(32)) | g_lo
        kept = np.argsort(key64, kind="stable")[:capacity]
    kept = kept[np.argsort(g0[kept])]
    want = {data[a:b]: int(c) for a, b, c in zip(
        starts[g0[kept]].tolist(), ends[g0[kept] + n - 1].tolist(),
        counts[kept].tolist())}
    return (want, m, m - int(counts[kept].sum()), len(g0),
            (g_hi, g_lo, counts))


def host_registers(key_hi, key_lo):
    """The HyperLogLog registers of these keys (p = 14)."""
    import numpy as np

    x = key_lo.astype(np.int64)
    bits = np.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        bits = np.where(big, bits + shift, bits)
        x = np.where(big, x >> shift, x)
    rho = 33 - (bits + (x > 0))
    regs = np.zeros(1 << HLL_P, np.int64)
    np.maximum.at(regs, key_hi.astype(np.int64) & ((1 << HLL_P) - 1), rho)
    return regs


def host_cms(key_hi, key_lo, counts):
    """The Count-Min sketch of these keys and counts (4 x 2**16, wrapping
    at 2**32)."""
    import numpy as np

    cms = np.zeros((CMS_DEPTH, CMS_WIDTH), np.int64)
    with np.errstate(over="ignore"):
        for r in range(CMS_DEPTH):
            h = _fmix32((key_hi ^ np.uint32(CMS_SALTS[r])) * np.uint32(FMIX_C1)
                        + key_lo * np.uint32(FMIX_C2) + np.uint32(r))
            np.add.at(cms[r], (h & np.uint32(CMS_WIDTH - 1)).astype(np.int64),
                      counts.astype(np.int64))
    return cms & 0xFFFFFFFF


def sketch_corpus(n_regions: int, region_bytes: int, vocab_n: int,
                  seed: int):
    """``(data, tokens)``: ``n_regions`` regions, each of ``region_bytes``
    of 5-byte words drawn uniformly from its own vocabulary of ``vocab_n``
    (region letter + 4 letters), a space after each, and the draws as
    :func:`host_tokens` gives them (so the counts are the generator's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(LETTERS, np.uint8)
    idx = np.arange(n_regions * vocab_n)
    words = np.empty((len(idx), 5), np.uint8)
    words[:, 0] = letters[idx // vocab_n]
    rest = idx % vocab_n
    for k in range(4, 0, -1):
        words[:, k] = letters[rest % 26]
        rest //= 26
    per = region_bytes // 6
    ids = np.concatenate([rng.integers(0, vocab_n, per) + r * vocab_n
                          for r in range(n_regions)])
    rows = np.full((len(ids), 6), 0x20, np.uint8)
    rows[:, :5] = words[ids]
    data = rows.tobytes()
    starts = np.arange(len(ids), dtype=np.int64) * 6
    # ids renumbered in order of first appearance, as host_tokens numbers
    seen, first = np.unique(ids, return_index=True)
    order = seen[np.argsort(first)]
    renum = np.empty(len(idx), np.int64)
    renum[order] = np.arange(len(order))
    vocab = [words[i].tobytes() for i in order.tolist()]
    return data, (starts, starts + 5, renum[ids], vocab)


def families_phase(drive, by_path: dict, tmp: Path, path: Path,
                   stream_data: bytes, words_data: bytes, dev) -> tuple:
    """Phase 9: the n-gram and sketched word-count families (see the
    module docstring).  Returns the bigram oracle of the phase-4 file,
    ``(want, total, dropped_count, distinct)``, for phases 11 and 12."""
    import contextlib
    import io
    import signal

    import numpy as np
    import torch

    from mapreduce_tpu_torch import Config, cli, count_file
    from mapreduce_tpu_torch.data import reader as reader_mod
    from mapreduce_tpu_torch.models import wordcount as wc
    from mapreduce_tpu_torch.ops import ngram as ngram_ops
    from mapreduce_tpu_torch.ops import sketch
    from mapreduce_tpu_torch.ops import table as table_ops
    from mapreduce_tpu_torch.runtime import checkpoint as ckpt_mod

    t_phase = time.perf_counter()
    cfg = Config()
    cap, w = cfg.table_capacity, cfg.pallas_max_token
    chunks = -(-len(stream_data) // cfg.chunk_bytes)

    def check(name, got, total, dropped, distinct):
        """The accounting beside drive's words, counts and total: dropped
        tokens exact; ``distinct`` the table's KMV estimate within four of
        its standard errors (``1 / sqrt(capacity)``, 0.2 % at 2**18) once
        it spilled, else exact, or an upper bound when grams were
        dropped."""
        if got.dropped_count != dropped:
            raise SystemExit(f"{name}: dropped_count {got.dropped_count}, "
                             f"expected {dropped}")
        if distinct > cap:
            ok = got.dropped_uniques > 0 \
                and abs(got.distinct - distinct) <= 4 * distinct / cap**0.5
        elif dropped:
            ok = got.dropped_uniques > 0 and got.distinct >= distinct
        else:
            ok = got.dropped_uniques == 0 and got.distinct == distinct
        if not ok:
            raise SystemExit(f"{name}: distinct {got.distinct} "
                             f"dropped_uniques {got.dropped_uniques}, "
                             f"expected {distinct} distinct")

    # 9a. single buffers: count_ngrams at Config() on phase 3's corpus and
    # on a copy with forty overlong URLs in 1,000 tokens, whose grams are
    # dropped and accounted; n = 2 under the radix sort and the fused map.
    over_data = make_corpus(32 * MB, SEED + 11, urls_per_mille=40)
    host = {"words": host_tokens(words_data), "over": host_tokens(over_data)}
    oracles = {(k, n): gram_oracle(d, host[k], n, w, cap)
               for k, d in (("words", words_data), ("over", over_data))
               for n in (2, 3)}
    pair = {"tokenize_pair": 1}
    runs = [("count_ngrams_2", "words", words_data, 2, cfg, pair),
            ("count_ngrams_3", "words", words_data, 3, cfg, pair),
            ("count_ngrams_2_overlong", "over", over_data, 2, cfg, pair),
            ("count_ngrams_3_overlong", "over", over_data, 3, cfg, pair),
            ("count_ngrams_2_radix", "words", words_data, 2,
             Config(sort_impl="radix"),
             {**pair, "radix_partition": 2, "radix_sort": 1}),
            ("count_ngrams_2_fused", "words", words_data, 2,
             Config(map_impl="fused"), {"tokenize_fused": 1})]
    for name, key, data, n, c, need in runs:
        want, total, dropped, distinct, _ = oracles[(key, n)]
        got, seconds = drive(name, lambda: wc.count_ngrams(data, n, c), want,
                             need, total=total)
        check(name, got, total, dropped, distinct)
        emit("families", path=name, n=n, bytes=len(data), grams=got.total,
             reported=len(got.words), distinct=distinct,
             dropped_count=got.dropped_count, seconds=round(seconds, 4),
             launches=by_path[name], equal_to_oracle=True)
    del over_data, host

    # 9b. streams: count_file over the phase-4 file (n = 2 and 3) and the
    # 8-file corpus (n = 2: each file ends on a token boundary, so the
    # expected result is the file's with every count x 8).  The seam
    # entries are the SEAM_GRAM_LENGTH windows the combines formed at the
    # chunk joins, counted and poisoned: n-1 at each join inside a file,
    # none across a file boundary (the carry resets there).  Past the
    # table's capacity few of them survive the merges; the host recovers
    # those.
    seam_tables: list = []
    seam_offsets: list = []
    real_seam = ngram_ops.seam_gram_table
    real_scan = reader_mod.scan_gram_lengths

    def kept_seam(prefix, first, n):
        seam_tables.append(real_seam(prefix, first, n))
        return seam_tables[-1]

    def counted_scan(paths, offsets, n, cut_offsets=None):
        seam_offsets.append(len(offsets))
        return real_scan(paths, offsets, n, cut_offsets)

    ngram_ops.seam_gram_table = kept_seam
    reader_mod.scan_gram_lengths = counted_scan
    corpus8 = [str(path)] * 8
    stream_host = host_tokens(stream_data)
    stream_oracle = {n: gram_oracle(stream_data, stream_host, n, w, cap)
                     for n in (2, 3)}
    del stream_host
    try:
        for n, files in ((2, 1), (3, 1), (2, 8)):
            want, total, dropped, distinct, _ = stream_oracle[n]
            name = f"count_file_ngram{n}" + ("_8files" if files > 1 else "")
            seam_tables.clear()
            seam_offsets.clear()
            got, seconds = drive(
                name, lambda: count_file(corpus8[:files], cfg, ngram=n),
                {k: v * files for k, v in want.items()}, {
                    "tokenize_pair": chunks * files}, total=total * files)
            check(name, got, total * files, dropped * files, distinct)
            formed = sum(int(t.count.sum()) for t in seam_tables)
            poisoned = sum(int(t.dropped_count) for t in seam_tables)
            joins = (chunks - 1) * files
            if formed + poisoned != joins * (n - 1) or not formed:
                raise SystemExit(f"{name}: {formed} seam entries and "
                                 f"{poisoned} poisoned windows at {joins} "
                                 f"joins")
            emit("families", path=name, n=n, files=files,
                 bytes=files * len(stream_data), chunks=chunks * files,
                 grams=got.total, reported=len(got.words),
                 seam_entries=formed, seam_windows_poisoned=poisoned,
                 seam_entries_recovered=sum(seam_offsets),
                 seconds=round(seconds, 4),
                 gb_per_s=files * len(stream_data) / seconds / 1e9,
                 recover_s=got.run.metrics.phases.get("recover"),
                 launches=by_path[name], equal_to_oracle=True)
    finally:
        ngram_ops.seam_gram_table = real_seam
        reader_mod.scan_gram_lengths = real_scan
    ngram2_want = stream_oracle[2][:4]
    del stream_oracle

    # 9c. preemption: SIGINT to a streamed n-gram CLI child once its first
    # snapshot landed; it must exit 75 and its relaunch print what an
    # uninterrupted run prints.
    argv = [*corpus8, "--stream", "--no-echo", "--format", "json",
            "--ngram", "2"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli.main(argv) != 0:
            raise SystemExit("the uninterrupted n-gram CLI run failed")
    want_out = buf.getvalue().encode()
    ck = str(tmp / "families_preempt.npz")
    cmd = [sys.executable, "-m", "mapreduce_tpu_torch", *argv,
           "--checkpoint", ck, "--checkpoint-every", "2"]
    with open(tmp / "families_preempt.log", "wb") as err:
        child = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=err)
        try:
            deadline = time.monotonic() + 600
            while child.poll() is None and time.monotonic() < deadline:
                if os.path.exists(ckpt_mod.integrity_path(ck)):
                    child.send_signal(signal.SIGINT)
                    break
                time.sleep(0.002)
            out, _ = child.communicate(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    log = (tmp / "families_preempt.log").read_text(errors="replace")
    if child.returncode != 75 or out:
        raise SystemExit(f"the interrupted n-gram CLI exited "
                         f"{child.returncode} (stdout {len(out)} bytes):\n"
                         f"{log[-3000:]}")
    _, step, offset, _, _ = ckpt_mod.load(ck)
    relaunch = subprocess.run(cmd, cwd=ROOT, capture_output=True, timeout=600)
    if relaunch.returncode != 0 or relaunch.stdout != want_out:
        raise SystemExit(f"the relaunched n-gram CLI exited "
                         f"{relaunch.returncode}, stdout equal "
                         f"{relaunch.stdout == want_out}:\n"
                         + relaunch.stderr.decode(errors="replace")[-3000:])
    emit("families", case="preemption", ngram=2, signal="SIGINT", exit=75,
         snapshot_step=step, snapshot_offset=offset,
         relaunch_stdout_bytes=len(relaunch.stdout),
         relaunch_equal_to_uninterrupted=True)

    # 9d. the sketches over four 32 MB regions, each of its own 120,000
    # words: ~480,000 distinct, past the 2**18 table, while every chunk's
    # batch table (2**18) holds each of its keys.
    sk_data, sk_tokens = sketch_corpus(4, 32 * MB, 120_000, SEED + 12)
    sk_path = tmp / "sketch.txt"
    sk_path.write_bytes(sk_data)
    sk_bytes = len(sk_data)
    want, total, dropped, distinct, (k_hi, k_lo, k_cnt) = gram_oracle(
        sk_data, sk_tokens, 1, None, cap)
    del sk_data
    regs_want = host_registers(k_hi, k_lo)
    cms_want = host_cms(k_hi, k_lo, k_cnt)
    sk_chunks = -(-sk_bytes // cfg.chunk_bytes)
    registers: list = []
    real_est = sketch.estimate

    def captured(regs):
        registers.append(regs.cpu().numpy())
        return real_est(regs)

    sketch.estimate = captured
    rates: dict = {1: [], 4: []}
    try:
        for kind, flush in (("distinct", 1), ("count", 1), ("count", 4),
                            ("count", 4), ("count", 1), ("distinct", 4)):
            c = Config(sketch_flush_every=flush)
            name = f"count_file_{kind}_sketch_f{flush}"
            registers.clear()
            got, seconds = drive(
                name, lambda: count_file(str(sk_path), c, **{
                    f"{kind}_sketch": True}), want,
                {"tokenize_compact": sk_chunks}, total=total)
            check(name, got, total, dropped, distinct)
            extra: dict = {}
            if kind == "distinct":
                if not np.array_equal(registers[-1], regs_want):
                    raise SystemExit(f"{name}: registers differ from the "
                                     f"host's")
                err = abs(got.distinct_estimate - distinct) / distinct
                if err > 0.03 or got.dropped_uniques <= 0:
                    raise SystemExit(f"{name}: estimate "
                                     f"{got.distinct_estimate} of {distinct}")
                extra = {"distinct_estimate": got.distinct_estimate,
                         "relative_error": err}
            else:
                if not np.array_equal(got.cms.astype(np.int64), cms_want):
                    raise SystemExit(f"{name}: the Count-Min sketch differs "
                                     f"from the host's")
                kept = set(got.words)
                vocab = sk_tokens[3]
                spilled = [i for i in range(0, len(vocab), 97)
                           if vocab[i] not in kept][:2000]
                low = [vocab[i] for i in spilled
                       if got.estimate_count(vocab[i]) < int(k_cnt[i])]
                if not spilled or low:
                    raise SystemExit(f"{name}: {len(low)} of {len(spilled)} "
                                     f"spilled words under-estimated")
                rates[flush].append(sk_bytes / seconds / 1e9)
                extra = {"spilled_words_checked": len(spilled)}
            emit("families", path=name, sketch=kind, flush_every=flush,
                 bytes=sk_bytes, distinct=distinct,
                 dropped_uniques=got.dropped_uniques,
                 seconds=round(seconds, 4),
                 gb_per_s=sk_bytes / seconds / 1e9, launches=by_path[name],
                 equal_to_host_sketch=True, **extra)
    finally:
        sketch.estimate = real_est
    card = card_name()
    emit("families", case="sketch_gb_per_s", card=card, bytes=sk_bytes,
         turns="count sketch f1, f4, f4, f1",
         flush_1=statistics.median(rates[1]),
         flush_4=statistics.median(rates[4]),
         flush_4_over_1=statistics.median(rates[4])
         / statistics.median(rates[1]))

    # 9e. times: streamed GB/s of n = 2 against the word count over the
    # 8-file corpus in turns; the n-gram step of one device-resident 32 MB
    # chunk beside the word count's, with the rows each sort sees; one HLL
    # and one CMS update of a batch table.
    n8 = 8 * len(stream_data)
    gbs: dict = {"wordcount": [], "ngram2": []}
    for name in ("wordcount", "ngram2", "ngram2", "wordcount"):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        count_file(corpus8, cfg, ngram=2 if name == "ngram2" else 1)
        gbs[name].append(n8 / (time.perf_counter() - t_a) / 1e9)
    emit("families", case="stream_gb_per_s", card=card, bytes=n8,
         turns="wc, ng, ng, wc",
         wordcount=statistics.median(gbs["wordcount"]),
         ngram2=statistics.median(gbs["ngram2"]),
         ngram2_over_wordcount=statistics.median(gbs["ngram2"])
         / statistics.median(gbs["wordcount"]))
    chunk = torch.frombuffer(bytearray(words_data), dtype=torch.uint8).to(dev)
    jobs = {"wordcount": wc.WordCountJob(cfg),
            "ngram2": wc.NGramCountJob(2, cfg),
            "ngram3": wc.NGramCountJob(3, cfg)}
    states = {k: j.init_state() for k, j in jobs.items()}
    sort_rows: dict = {}
    build = table_ops.from_packed_rows

    def step(name):
        j = jobs[name]
        fn = getattr(j, "map_chunk_sharded", j.map_chunk)
        return j.combine(states[name], fn(chunk, 0))

    for name in jobs:
        def record(key_hi, *args, _name=name, **kw):
            sort_rows.setdefault(_name, []).append(key_hi.shape[0])
            return build(key_hi, *args, **kw)
        table_ops.from_packed_rows = record
        try:
            step(name)
        finally:
            table_ops.from_packed_rows = build
    step_ms: dict = {k: [] for k in jobs}
    for rep in range(11):
        for name in jobs:
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            step(name)
            torch.cuda.synchronize()
            if rep:
                step_ms[name].append((time.perf_counter() - t_a) * 1e3)
    batch = jobs["wordcount"].map_chunk(chunk, 0)
    valid = batch.count > 0
    regs = sketch.empty(device=dev)
    cms = sketch.cms_empty(device=dev)
    emit("families", case="times", card=card, chunk_bytes=chunk.shape[0],
         step_ms={k: statistics.median(v) for k, v in step_ms.items()},
         sort_rows=sort_rows, batch_rows=batch.key_hi.shape[0],
         batch_live_rows=int(valid.sum()),
         hll_update_ms=cuda_ms(lambda: sketch.update_from_keys(
             regs, batch.key_hi, batch.key_lo, valid)),
         cms_update_ms=cuda_ms(lambda: sketch.cms_update(
             cms, batch.key_hi, batch.key_lo, batch.count)),
         cms_update_rows=4 * batch.key_hi.shape[0])
    emit("families", case="wall", seconds=time.perf_counter() - t_phase)
    return ngram2_want


# The grep and sample oracles of phase 10, in numpy and independent of the
# port's code: a pattern is a list of allowed-byte tables, one a position
# (written out by hand for the class pattern), and the priorities are the
# JAX package's hash of (chunk id, in-chunk offset).
def byte_set(*ranges) -> "np.ndarray":
    import numpy as np

    lut = np.zeros(256, bool)
    for lo, hi in ranges:
        lut[lo:hi + 1] = True
    return lut


def literal_luts(pattern: bytes) -> list:
    return [byte_set((b, b)) for b in pattern]


def pattern_hits(arr, luts, cuts) -> "np.ndarray":
    """Start offsets of every overlapping occurrence in ``arr`` (one file)
    that lies inside one row: a match over a row start in ``cuts`` is the
    chunk-join envelope (no pattern matches across a join)."""
    import numpy as np

    m, n = len(luts), arr.shape[0]
    if m > n:
        return np.zeros(0, np.int64)
    order = sorted(range(m), key=lambda i: int(luts[i].sum()))
    first = order[0]
    cand = np.flatnonzero(luts[first][arr[first:n - m + 1 + first]])
    for i in order[1:]:
        cand = cand[luts[i][arr[cand + i]]]
    if len(cuts):
        nxt = np.searchsorted(cuts, cand, side="right")
        crossing = (nxt < len(cuts)) & (
            cuts[np.minimum(nxt, len(cuts) - 1)] < cand + m)
        cand = cand[~crossing]
    return cand


def matching_lines(hits, nlpos) -> int:
    """Lines with a match under the JAX package's segment convention: a
    match counts unless the match before it lies in the scan segment of
    the byte before it (a newline opens its own segment)."""
    import numpy as np

    if not len(hits):
        return 0
    before = np.searchsorted(nlpos, hits, side="left")
    upto = np.searchsorted(nlpos, hits, side="right")
    return 1 + int(np.count_nonzero(upto[:-1] != before[1:]))


def host_priorities(pos, cid):
    """uint32 ``(prio_hi, prio_lo)`` of token occurrences."""
    import numpy as np

    with np.errstate(over="ignore"):
        s1 = (pos * np.uint32(HASH_BASE_1)) \
            ^ _fmix32(cid + np.uint32(0x9E3779B9))
        s2 = (pos * np.uint32(HASH_BASE_2)) \
            ^ _fmix32(cid ^ np.uint32(0x85EBCA6B))
        hi = _fmix32(s1)
        lo = _fmix32(s2)
    return np.where(hi == SENT, np.uint32(SENT - 1), hi), lo


def sample_candidates(spans, row_starts, row0: int, k: int, w: int):
    """One file's at most ``k`` smallest occurrences (ties at the k-th
    priority all kept) as ``(prio_hi, prio_lo, cid, pos, start, end)`` and
    its population (tokens of at most ``w`` bytes); ``row_starts`` are
    the file's row offsets, the first 0, and its rows have chunk ids
    ``row0, row0 + 1, ...``."""
    import numpy as np

    starts, ends = spans
    keep = (ends - starts) <= w
    s, e = starts[keep], ends[keep]
    r = np.searchsorted(row_starts, s, side="right") - 1
    cid = (row0 + r).astype(np.uint32)
    pos = (s - row_starts[r]).astype(np.uint32)
    hi, lo = host_priorities(pos, cid)
    key = (hi.astype(np.uint64) << np.uint64(32)) | lo
    kk = min(k, len(key))
    kth = np.partition(key, kk - 1)[kk - 1]
    sel = np.flatnonzero(key <= kth)
    return (hi[sel], lo[sel], cid[sel], pos[sel], s[sel], e[sel]), len(s)


def bottom_k(cands: list, k: int):
    """The k smallest of the files' candidates by (priority, chunk id,
    offset): the JAX bottom-k order."""
    import numpy as np

    hi, lo, cid, pos, s, e = (np.concatenate(x) for x in zip(*cands))
    order = np.lexsort((pos, cid, lo, hi))[:k]
    return s[order], e[order]



def grep_sample_phase(by_path: dict, tmp: Path, path: Path,
                      stream_data: bytes, words_data: bytes, dev) -> None:
    """Phase 10: grep and the reservoir sample (see the module
    docstring)."""
    import warnings

    import numpy as np
    import torch

    from mapreduce_tpu_torch import Config, count_file
    from mapreduce_tpu_torch.models import grep, sample
    from mapreduce_tpu_torch.models import wordcount as wc
    from mapreduce_tpu_torch.ops.cuda import radix
    from mapreduce_tpu_torch.ops.cuda import tokenize as ktok
    from mapreduce_tpu_torch.runtime import executor

    t_phase = time.perf_counter()
    cfg = Config()
    w = cfg.pallas_max_token
    card = card_name()
    corpus8 = [str(path)] * 8
    file_bytes = len(stream_data)
    arr = {"words": np.frombuffer(words_data, np.uint8),
           "file": np.frombuffer(stream_data, np.uint8)}
    nlpos = {k: np.flatnonzero(a == 0x0A) for k, a in arr.items()}
    o = next(i for i in range(MB, 2 * MB)
             if stream_data[i - 1] == 0x20 and stream_data[i] != 0x20)
    lit32 = stream_data[o:o + 32]
    lower = (ord("a"), ord("z"))
    # name -> (patterns, syntax, the oracle's tables of each pattern)
    sets = {
        "the": ([b"the"], "literal", [literal_luts(b"the")]),
        "lit32": ([lit32], "literal", [literal_luts(lit32)]),
        "class_space": ([b"[a-z]e [t-z]"], "class", [[
            byte_set(lower), byte_set((0x65, 0x65)), byte_set((0x20, 0x20)),
            byte_set((ord("t"), ord("z")))]]),
        "four_nl": ([b"the", b"er", b"and", b"\nt"], "literal",
                    [literal_luts(p) for p in (b"the", b"er", b"and",
                                               b"\nt")]),
    }

    # Every streamed run's row bases, for the oracles' envelope and the
    # sample's chunk ids: the entry points return none, so run_job's
    # result is kept on its way out.
    runs: list = []
    real_run_job = executor.run_job

    def kept_run_job(*a, **kw):
        runs.append(real_run_job(*a, **kw))
        return runs[-1]

    reads = {"host_read": 0}
    real_span = wc.span

    def counted_span(name, timer=None):
        reads[name] = reads.get(name, 0) + 1
        return real_span(name, timer)

    def drive_gs(name: str, fn, tokenize_pair: int):
        """One path between cleared counters: its launches (the sample's
        map launches pair mode once a chunk, grep's map no kernel), no
        spill fallback, and its ``host_read`` spans."""
        torch.cuda.synchronize()
        ktok.LAUNCHES.clear()
        radix.LAUNCHES.clear()
        wc.BRANCHES.clear()
        reads["host_read"] = 0
        t_a = time.perf_counter()
        got = fn()
        seconds = time.perf_counter() - t_a
        by_path[name] = {**ktok.LAUNCHES, **radix.LAUNCHES}
        want = {"tokenize_pair": tokenize_pair} if tokenize_pair else {}
        if by_path[name] != want or wc.BRANCHES:
            raise SystemExit(f"{name} launched {by_path[name]}, took "
                             f"{dict(wc.BRANCHES)}; expected {want}")
        return got, seconds, reads["host_read"]

    def file_cuts(rr, f: int):
        """File f's row starts relative to the file, from a run's bases."""
        b = rr.bases[:, 0]
        rel = b[(b >= f * file_bytes) & (b < (f + 1) * file_bytes)] \
            - f * file_bytes
        return rel, int(np.flatnonzero(b >= f * file_bytes)[0])

    def grep_want(key: str, luts_list, cuts_per_file):
        """(matches, lines) of each pattern, summed over the files."""
        out = []
        cache: dict = {}
        for luts in luts_list:
            m = ln = 0
            for cuts in cuts_per_file:
                ck = (id(luts), cuts.tobytes())
                if ck not in cache:
                    hits = pattern_hits(arr[key], luts, cuts)
                    cache[ck] = (len(hits), matching_lines(hits, nlpos[key]))
                m += cache[ck][0]
                ln += cache[ck][1]
            out.append((m, ln))
        return out

    executor.run_job = kept_run_job
    wc.span = counted_span
    try:
        # 10a. grep: each pattern set over the 32 MB buffer (one row), the
        # phase-4 file and the 8-file corpus.
        for name, (pats, syntax, luts) in sets.items():
            single = len(pats) == 1
            inputs = [("grep_bytes", "words", None),
                      ("grep_file", "file", [str(path)]),
                      ("grep_file_8files", "file", corpus8)]
            for entry, key, files in inputs:
                path_name = f"{entry}_{name}"
                runs.clear()
                if files is None:
                    fn = (lambda: [grep.grep_bytes(words_data, pats[0],
                                                   syntax)]) if single \
                        else (lambda: grep.grep_bytes_multi(words_data, pats,
                                                            syntax))
                else:
                    fn = (lambda: [grep.grep_file(files, pats[0], cfg,
                                                  syntax=syntax)]) if single \
                        else (lambda: grep.grep_file_multi(files, pats, cfg,
                                                           syntax=syntax))
                got, seconds, n_reads = drive_gs(path_name, fn, 0)
                if files is None:
                    cuts, chunks = [np.zeros(0, np.int64)], 1
                else:
                    cuts = [file_cuts(runs[0], f)[0][1:]
                            for f in range(len(files))]
                    chunks = runs[0].bases.shape[0]
                want = grep_want(key, luts, cuts)
                have = [(r.matches, r.lines) for r in got]
                if have != want:
                    raise SystemExit(f"{path_name}: {have}, oracle {want}")
                if n_reads:
                    raise SystemExit(f"{path_name} read the host {n_reads} "
                                     "times")
                emit("grep_sample", path=path_name, patterns=[
                    p.decode(errors="backslashreplace") for p in pats],
                    syntax=syntax, bytes=len(words_data) if files is None
                    else file_bytes * len(files), chunks=chunks,
                    matches=[h[0] for h in have], lines=[h[1] for h in have],
                    seconds=round(seconds, 4), host_reads=n_reads,
                    launches=by_path[path_name], equal_to_oracle=True)

        # 10b. sample: k = 16 and 4,096 over the same inputs.  Each
        # input's candidates are taken once, at the largest k: a smaller
        # k's bottom-k lies among them.
        spans = {"words": token_spans(words_data),
                 "file": token_spans(stream_data)}
        k_max = 4096
        cands_of: dict = {}
        for k in (16, k_max):
            for entry, key, files in (("sample_bytes", "words", None),
                                      ("sample_file", "file", [str(path)]),
                                      ("sample_file_8files", "file",
                                       corpus8)):
                path_name = f"{entry}_k{k}"
                runs.clear()
                chunks = 1 if files is None \
                    else len(files) * -(-file_bytes // cfg.chunk_bytes)
                fn = (lambda: sample.sample_bytes(words_data, k, cfg)) \
                    if files is None \
                    else (lambda: sample.sample_file(files, k, cfg))
                got, seconds, n_reads = drive_gs(path_name, fn, chunks)
                if entry in cands_of:
                    cands, population = cands_of[entry]
                elif files is None:
                    cands, total = sample_candidates(
                        spans["words"], np.zeros(1, np.int64), 0, k_max, w)
                    cands, population = [cands], total
                else:
                    cands, population = [], 0
                    for f in range(len(files)):
                        rows, row0 = file_cuts(runs[0], f)
                        c, n_tok = sample_candidates(spans["file"], rows,
                                                     row0, k_max, w)
                        cands.append(c)
                        population += n_tok
                cands_of[entry] = cands, population
                data = words_data if files is None else stream_data
                s_, e_ = bottom_k(cands, k)
                want = [data[a:b] for a, b in zip(s_.tolist(),
                                                  e_.tolist())]
                if got.tokens != want or got.total != population:
                    raise SystemExit(f"{path_name}: sample or population "
                                     f"({got.total} of {population}) "
                                     "differs from the oracle")
                if n_reads > chunks:
                    raise SystemExit(f"{path_name} read the host {n_reads} "
                                     f"times in {chunks} chunks")
                emit("grep_sample", path=path_name, k=k,
                     bytes=len(words_data) if files is None
                     else file_bytes * len(files), chunks=chunks,
                     population=got.total, sampled=len(got.tokens),
                     first=[t.decode(errors="backslashreplace")
                            for t in got.tokens[:4]],
                     seconds=round(seconds, 4), host_reads=n_reads,
                     launches=by_path[path_name], equal_to_oracle=True)
    finally:
        executor.run_job = real_run_job
        wc.span = real_span
    del spans

    # 10c. streamed GB/s over the 8-file corpus, in turns with the word
    # count.
    n8 = 8 * file_bytes
    four = sets["four_nl"][0]
    turns = ["wordcount", "grep", "grep4", "sample16", "sample16", "grep4",
             "grep", "wordcount"]
    arms = {"wordcount": lambda: count_file(corpus8, cfg),
            "grep": lambda: grep.grep_file(corpus8, b"the", cfg),
            "grep4": lambda: grep.grep_file_multi(corpus8, four, cfg),
            "sample16": lambda: sample.sample_file(corpus8, 16, cfg)}
    gbs: dict = {k: [] for k in arms}
    for name in turns:
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        arms[name]()
        gbs[name].append(n8 / (time.perf_counter() - t_a) / 1e9)
    med = {k: statistics.median(v) for k, v in gbs.items()}
    emit("grep_sample", case="stream_gb_per_s", card=card, bytes=n8,
         turns=", ".join(turns), gb_per_s=med, runs=gbs,
         over_wordcount={k: v / med["wordcount"] for k, v in med.items()})

    # 10d. one device-resident 32 MB chunk: each job's step (map +
    # combine), host clock in turns; its device time and kernel launches
    # (profiler); its peak memory above the chunk; its host syncs (CUDA's
    # sync debug mode, which warns on every synchronising call).
    chunk = torch.frombuffer(bytearray(words_data), dtype=torch.uint8).to(dev)
    jobs = {"wordcount": wc.WordCountJob(cfg),
            "grep_p1": grep.GrepJob(b"the"),
            "grep_p4": grep.MultiGrepJob(four),
            "sample_k16": sample.ReservoirSampleJob(16, cfg),
            "sample_k4096": sample.ReservoirSampleJob(4096, cfg)}
    states = {k: j.init_state() for k, j in jobs.items()}

    def step(name):
        j = jobs[name]
        fn = getattr(j, "map_chunk_sharded", j.map_chunk)
        return j.combine(states[name], fn(chunk, 0))

    step_ms: dict = {k: [] for k in jobs}
    for rep in range(11):
        for name in jobs:
            torch.cuda.synchronize()
            t_a = time.perf_counter()
            step(name)
            torch.cuda.synchronize()
            if rep:
                step_ms[name].append((time.perf_counter() - t_a) * 1e3)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device_ms, launches, peak_mb, syncs = {}, {}, {}, {}
    for name in jobs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step(name)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total]
        device_ms[name] = sum(e.self_device_time_total for e in events) / 3e3
        launches[name] = sum(e.count for e in events) / 3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        step(name)
        torch.cuda.synchronize()
        peak_mb[name] = (torch.cuda.max_memory_allocated(dev) - base) / MB
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(name)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs[name] = sum("synchroniz" in str(c.message) for c in caught)
    if syncs["grep_p1"] or syncs["grep_p4"] \
            or syncs["sample_k16"] > 1 or syncs["sample_k4096"] > 1:
        raise SystemExit(f"host syncs in a step: {syncs}")
    emit("grep_sample", case="times", card=card, chunk_bytes=chunk.shape[0],
         step_ms={k: statistics.median(v) for k, v in step_ms.items()},
         device_ms_per_step=device_ms, device_launches_per_step=launches,
         peak_mb_above_chunk=peak_mb, host_syncs_per_step=syncs)
    del chunk, states
    wall = time.perf_counter() - t_phase
    emit("grep_sample", case="wall", seconds=wall, limit_s=120,
         within_limit=wall <= 120)


# One rank of a many-ranks world: argv = repo root, the spec (JSON).  Runs
# every case between cleared launch counters and writes this rank's
# {case: measurements (and, on the coordinator, the result)} as JSON.  A
# case's finish ms holds the rank's wait for its peers' streams (the last
# step's rows differ in length).
#: The ladder's policy: one resource retry, then a rung down.
LADDER_POLICY = {"resource_retries": 1, "transient_retries": 1,
                 "degrade": True, "backoff_base_s": 0.0, "jitter_frac": 0.0}
#: The storm's first rung: every rung of the ladder is below it.
LADDER_START = {"map_impl": "fused", "combiner": "hot-cache",
                "sort_impl": "radix"}


def result_fields(r) -> dict | None:
    """A word-count result as its digest and totals (None off the
    coordinator)."""
    if r is None:
        return None
    return {"digest": result_digest(r.words, r.counts), "words": len(r.words),
            "total": r.total, "distinct": r.distinct,
            "dropped_uniques": r.dropped_uniques,
            "dropped_count": r.dropped_count}


def predicted_partials(groups_per_file: list, window: int,
                       hook: bool) -> int:
    """The window-boundary partials of a run (``_OverlapMerger.due``, the
    JAX rule): a sliding window of ``window`` groups retires its oldest
    when full, a partial fires once ``window`` groups retired since the
    last one, and for a job with a boundary hook every file boundary
    drains the window and fires one."""
    retired = last = inflight = partials = 0
    for f, groups in enumerate(groups_per_file):
        if f and hook:
            retired, inflight = retired + inflight, 0
            partials, last = partials + 1, retired
        for _ in range(groups):
            while inflight >= window:
                inflight, retired = inflight - 1, retired + 1
            if retired - last >= window:
                partials, last = partials + 1, retired
            inflight += 1
    return partials


def rank_case(kind: str, args: dict, spec: dict, dev, mesh,
              runs: list) -> tuple:
    """One case of phases 11 and 12 in a rank's child (both children
    import it): window-boundary merges (``overlap``: the word count,
    bigrams or grep over the 8-file corpus with ``merge_overlap``, the
    coordinator's ledger giving each partial's interval and the residual
    finish's), streamed GB/s (``turn``: overlap on or off, ``retry`` 1 or
    0), window replay (``replay``: a dispatch fault on the ranks in
    ``plan_ranks``, ``retry=2``) and the ladder (``storm``: every step on
    the ranks in ``ranks`` fails as out of memory until the torch sort).
    ``runs`` holds each ``run_job``'s result.  Returns ``(result,
    extra)``."""
    import torch.distributed as tdist

    from mapreduce_tpu_torch import Config, count_file
    from mapreduce_tpu_torch.models import grep
    from mapreduce_tpu_torch.obs import ledger
    from mapreduce_tpu_torch.obs.telemetry import Telemetry
    from mapreduce_tpu_torch.parallel import mapreduce as pmr

    rank = tdist.get_rank()
    kw = {} if mesh is None else {"mesh": mesh}
    path = spec["path"]
    if kind in ("overlap", "turn"):
        corpus8 = [path] * 8
        cfg = Config(merge_strategy=args.get("strategy", "tree"),
                     merge_overlap=args.get("overlap", True))
        led = os.path.join(spec["out"], f"{args['name']}.jsonl")
        if rank == 0 and os.path.exists(led):
            os.unlink(led)
        tel = Telemetry.create(ledger_path=led if rank == 0 else None,
                               progress_every_s=3600) \
            if kind == "overlap" else None
        try:
            if args.get("patterns"):
                res = [(x.matches, x.lines) for x in grep.grep_file_multi(
                    corpus8, [p.encode() for p in args["patterns"]], cfg,
                    dev, telemetry=tel, **kw)]
            else:
                res = result_fields(count_file(
                    corpus8, cfg, dev, ngram=args.get("ngram", 1),
                    retry=args.get("retry", 0), telemetry=tel, **kw))
        finally:
            if tel is not None:
                tel.close()
        pipe = runs[-1].pipeline
        extra = {"partials": pipe.get("partial_merges"),
                 "agreements": pipe.get("agreements"),
                 "agree_ms": pipe.get("agree_ms")}
        if tel is not None and rank == 0:
            recs = [r for r in ledger.read_ledger(led)
                    if r["kind"] == "collective"]
            extra["partial_ms"] = [
                round((r["ended_at"] - r["started_at"]) * 1e3, 3)
                for r in recs if r["op"] == "partial"]
            extra["residual_ms"] = [
                round((r["ended_at"] - r["started_at"]) * 1e3, 3)
                for r in recs if r["op"] == "finish"]
        return res, extra
    if kind == "replay":
        plan = args["plan"] if rank in args["plan_ranks"] else None
        res = result_fields(count_file(path, Config(fault_plan=plan), dev,
                                       retry=2, **kw))
    else:  # storm
        cfg = Config(**LADDER_START, inflight_groups=1,
                     failure_policy=LADDER_POLICY)
        real = pmr.Engine.step

        def storming(self, state, chunk, step_index):
            if rank in args["ranks"] and self.job.config.sort_impl != "xla":
                raise RuntimeError("RESOURCE_EXHAUSTED: injected storm")
            return real(self, state, chunk, step_index)

        pmr.Engine.step = storming
        try:
            res = result_fields(count_file(path, cfg, dev, **kw))
        finally:
            pmr.Engine.step = real
    rr = runs[-1]
    return res, {"replay_ms": round(rr.metrics.phases.get("replay", 0.0)
                                    * 1e3, 3),
                 "recoveries": rr.pipeline.get("recoveries", 0),
                 "degrade_steps": rr.pipeline.get("degrade_steps", []),
                 "agreements": rr.pipeline.get("agreements"),
                 "agree_ms": rr.pipeline.get("agree_ms")}


MANY_RANKS_CHILD = """
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
spec = json.loads(sys.argv[2])
import torch
from mapreduce_tpu_torch import Config, count_file
from mapreduce_tpu_torch.models import grep, sample
from mapreduce_tpu_torch.obs import registry
from mapreduce_tpu_torch.ops.cuda import tokenize as ktok
from mapreduce_tpu_torch.parallel import collectives, distributed
from mapreduce_tpu_torch.parallel.mesh import data_mesh
from mapreduce_tpu_torch.runtime import executor

from chip_smoke import rank_case

dev = distributed.initialize("gpu", backend=spec["backend"], timeout_s=240)
axis = data_mesh(device=dev)
cfg = Config()
runs = []
real_run_job = executor.run_job

def kept_run_job(*a, **kw):
    runs.append(real_run_job(*a, **kw))
    return runs[-1]

executor.run_job = kept_run_job

def sent():
    snap = registry.get_registry().snapshot()["counters"]
    return {k: v for k, v in snap.items()
            if k.startswith("collectives.bytes_sent")}

out = {"rank": axis.rank, "size": axis.size, "backend": axis.backend,
       "device": str(dev), "cases": {}}
for case in spec["cases"]:
    kind, args = case["kind"], case["args"]
    torch.cuda.synchronize(dev)
    # Every rank starts the case together, so no rank's seconds hold its
    # wait for a peer still recovering the previous case's strings.
    torch.distributed.barrier()
    ktok.LAUNCHES.clear()
    runs.clear()
    before = sent()
    t0 = time.perf_counter()
    extra = {}
    if kind == "count_file":
        r = count_file(spec["path"], Config(
            merge_strategy=args["strategy"],
            merge_every=args.get("merge_every", 1)), dev,
            ngram=args.get("ngram", 1))
        res = None if r is None else {"words": [w.hex() for w in r.words],
            "counts": r.counts, "total": r.total, "distinct": r.distinct,
            "dropped_uniques": r.dropped_uniques,
            "dropped_count": r.dropped_count}
    elif kind in ("overlap", "turn", "replay", "storm"):
        res, extra = rank_case(kind, dict(args, name=case["name"]), spec,
                               dev, None, runs)
    elif kind == "grep":
        rs = grep.grep_file_multi(spec["path"],
                                  [p.encode() for p in args["patterns"]],
                                  cfg, dev)
        res = [(x.matches, x.lines) for x in rs]
    else:
        r = sample.sample_file(spec["path"], args["k"], cfg, dev)
        res = None if r is None else {
            "tokens": [t.hex() for t in r.tokens], "total": r.total}
    seconds = time.perf_counter() - t0
    after = sent()
    rr = runs[-1]
    out["cases"][case["name"]] = {
        "seconds": seconds, "result": res, **extra,
        "reduce_s": rr.metrics.phases.get("reduce"),
        "steps": int(rr.bases.shape[0]), "bases": rr.bases.tolist(),
        "launches": dict(ktok.LAUNCHES),
        "bytes_sent": {k: after[k] - before.get(k, 0) for k in after
                       if after[k] != before.get(k, 0)}}
# The per-step all_gather of the n-gram map (10 words, n = 2) and of
# grep's map (3 words a pattern, P = 4): milliseconds a call, synchronised.
for name, shape in (("ngram2_summary", (10, 1)), ("grep4_summary", (3, 4))):
    x = torch.zeros(shape, dtype=torch.int64, device=dev)
    for _ in range(5):
        collectives.all_gather(x, axis)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(50):
        collectives.all_gather(x, axis)
    torch.cuda.synchronize(dev)
    out["all_gather_ms_" + name] = (time.perf_counter() - t0) / 50 * 1e3
with open(os.path.join(spec["out"], f"rank{axis.rank}.json"), "w") as f:
    json.dump(out, f)
distributed.shutdown()
"""


def run_world(n: int, backend: str, spec: dict, out: Path,
              timeout_s: float = 300, child: str = MANY_RANKS_CHILD,
              hosts: int = 1, expect_rc: int = 0) -> list:
    """Start ``n`` ranks of one world (``child``, by default
    ``MANY_RANKS_CHILD``) laid out as ``hosts`` nodes of ``n // hosts``
    ranks (``LOCAL_WORLD_SIZE``, ``GROUP_RANK``), join them with a time
    limit, and return each rank's measurements; any rank's failure (an
    exit code other than ``expect_rc``) or the time limit fails the
    smoke."""
    import socket

    out.mkdir(parents=True, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    spec = dict(spec, out=str(out), backend=backend)
    local = n // hosts
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r),
                   LOCAL_RANK=str(r % local), LOCAL_WORLD_SIZE=str(local),
                   GROUP_RANK=str(r // local),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        log = open(out / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", child, str(ROOT),
             json.dumps(spec)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != expect_rc]
    if bad:
        tails = {r: (out / f"rank{r}.log").read_text()[-3000:] for r in bad}
        raise SystemExit(f"{backend} world of {n} ranks: rank(s) {bad} "
                         f"failed or timed out: {tails}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(n)]


def hold_count(label: str, got: dict, ref, oracle_words: dict,
               ngram_want=None) -> None:
    """A world's word-count (or bigram) result field by field against one
    rank's run, and its words against the oracle.  A spilled gram table
    bounds its dropped keys per merge order: ``dropped_uniques`` is then
    held to the oracle's true count from above."""
    words = [bytes.fromhex(x) for x in got["words"]]
    fields = {"words": words, **{f: got[f] for f in (
        "counts", "total", "distinct", "dropped_uniques", "dropped_count")}}
    spilled = ngram_want is not None \
        and ngram_want[3] > len(ngram_want[0])
    differ = [f for f, v in fields.items() if v != getattr(ref, f)
              and not (spilled and f == "dropped_uniques")]
    if differ:
        raise SystemExit(f"{label} differs from one rank's run in {differ}")
    if dict(zip(words, got["counts"])) != oracle_words \
            or words != list(oracle_words):
        raise SystemExit(f"{label} differs from the oracle")
    if spilled and (got["dropped_count"] != ngram_want[2]
                    or got["dropped_uniques"]
                    < ngram_want[3] - len(ngram_want[0])):
        raise SystemExit(f"{label}: dropped {got['dropped_count']} tokens, "
                         f"{got['dropped_uniques']} keys; oracle "
                         f"{ngram_want[2]}, "
                         f"{ngram_want[3] - len(ngram_want[0])}")


def rank_cases(strategies, patterns, turns: bool, n: int) -> list:
    """The cases phases 11 and 12 add to their worlds: the word count over
    the 8-file corpus with window-boundary merges under each strategy,
    bigrams and grep with four patterns; on one axis the GB/s turns
    (overlap on, off, off, on; ``retry`` 1, 0, 0, 1); a dispatch fault
    under ``retry=2`` on every rank and on rank 1 alone; and a resource
    storm on every rank."""
    every = list(range(max(n, 2)))
    cases = [{"name": f"overlap_{s}", "kind": "overlap",
              "args": {"strategy": s}} for s in strategies]
    cases += [{"name": "overlap_ngram2", "kind": "overlap",
               "args": {"ngram": 2}},
              {"name": "overlap_grep_p4", "kind": "overlap",
               "args": {"patterns": patterns}}]
    if turns:
        for i, arm in enumerate(("on", "off", "off", "on", "retry1",
                                 "retry0", "retry0", "retry1")):
            cases.append({"name": f"turn{i}_{arm}", "kind": "turn",
                          "args": {"overlap": arm == "on",
                                   "retry": int(arm == "retry1")}})
    plan = "at=dispatch:1:transient"
    cases += [{"name": "replay_every_rank", "kind": "replay",
               "args": {"plan": plan, "plan_ranks": every}},
              {"name": "replay_rank1", "kind": "replay",
               "args": {"plan": plan, "plan_ranks": [1]}},
              {"name": "storm_every_rank", "kind": "storm",
               "args": {"ranks": every}}]
    return cases


def hold_rank_cases(label: str, cases: list, ranks: list, steps1: int,
                    ref: dict, ngram_want, n_bytes8: int) -> dict:
    """Phases 11 and 12: a world's ``rank_cases`` held to one rank's runs
    on the card (``ref``: the 8-file word count, bigrams and grep, and the
    phase-4 file's count, each already held to the oracle) and to the
    predicted partials and launches; returns each case's measurements."""
    from mapreduce_tpu_torch import Config

    window = Config().inflight_groups
    n = len(ranks)
    head = ranks[0]["cases"]
    out = {}
    for case in cases:
        name, kind, args = case["name"], case["kind"], case["args"]
        mine = [r["cases"][name] for r in ranks]
        got = head[name]["result"]
        want_l = {"tokenize_compact": 8 * steps1}
        partials = None
        if kind in ("overlap", "turn"):
            if args.get("patterns"):
                want_l = {}
                hook, want = True, ref["grep8"]
                for r, m in enumerate(mine):
                    if [tuple(x) for x in m["result"]] != want:
                        raise SystemExit(f"{label} {name} on rank {r}: "
                                         f"{m['result']}, one rank {want}")
            elif args.get("ngram"):
                want_l = {"tokenize_pair": 8 * steps1}
                hook, want = True, ref["ngram8"]
                spilled = ngram_want[3] > len(ngram_want[0])
                differ = [f for f in want if got[f] != want[f]
                          and not (spilled and f == "dropped_uniques")]
                if differ or got["dropped_uniques"] \
                        < ngram_want[3] - len(ngram_want[0]):
                    raise SystemExit(f"{label} {name} differs from one "
                                     f"rank's run in {differ}: {got}")
            else:
                hook = False
                if got != ref["count8"]:
                    raise SystemExit(f"{label} {name}: {got}, one rank and "
                                     f"the oracle {ref['count8']}")
            if args.get("overlap", True):
                partials = predicted_partials([steps1] * 8, window, hook)
                if any(m["partials"] != partials for m in mine):
                    raise SystemExit(f"{label} {name}: partials "
                                     f"{[m['partials'] for m in mine]}, "
                                     f"predicted {partials}")
        else:
            if got != ref["count1"]:
                raise SystemExit(f"{label} {name}: {got}, one rank and the "
                                 f"oracle {ref['count1']}")
            hit = any(r in range(n) for r in args.get(
                "plan_ranks", args.get("ranks", [])))
            for r, m in enumerate(mine):
                if kind == "replay" and (m["recoveries"] >= 1) != hit:
                    raise SystemExit(f"{label} {name} on rank {r}: "
                                     f"{m['recoveries']} recoveries")
                if kind == "storm" and m["degrade_steps"] != (
                        ["combiner-off", "map-split", "sort-xla"]
                        if hit else []):
                    raise SystemExit(f"{label} {name} on rank {r}: "
                                     f"{m['degrade_steps']}")
            want_l = None
        for r, m in enumerate(mine):
            if want_l is None:  # a replay relaunches: at least one a step
                if m["launches"].get("tokenize_compact", 0) < steps1:
                    raise SystemExit(f"{label} {name} rank {r} launched "
                                     f"{m['launches']}")
            elif m["launches"] != want_l:
                raise SystemExit(f"{label} {name} rank {r} launched "
                                 f"{m['launches']}, expected {want_l}")
        rec = {"seconds": [round(m["seconds"], 4) for m in mine],
               "finish_ms": [round((m["reduce_s"] or 0) * 1e3, 3)
                             for m in mine],
               "bytes_sent_per_rank": [m["bytes_sent"] for m in mine],
               "launches_per_rank": [m["launches"] for m in mine],
               "agree_us_per_crossing": [
                   round(m["agree_ms"] * 1e3 / m["agreements"], 2)
                   if m.get("agreements") else None for m in mine]}
        if partials is not None:
            rec.update(partials_predicted=partials,
                       partials=[m["partials"] for m in mine],
                       partial_ms=head[name].get("partial_ms"),
                       residual_ms=head[name].get("residual_ms"))
        if kind == "turn":
            rec["gb_per_s"] = n_bytes8 / head[name]["seconds"] / 1e9
        if kind in ("replay", "storm"):
            rec.update(replay_ms=[m["replay_ms"] for m in mine],
                       recoveries=[m["recoveries"] for m in mine],
                       degrade_steps=head[name]["degrade_steps"])
        out[name] = rec
    return out


#: One rank of a CLI world on card 0 (argv: the repo root, the CLI's
#: argv as JSON): what a launcher's rank runs, over gloo.
CLI_RANK_CHILD = """
import json, sys
sys.path.insert(0, sys.argv[1])
from mapreduce_tpu_torch import cli
from mapreduce_tpu_torch.parallel import distributed
distributed.initialize("gpu", backend="gloo", timeout_s=120)
try:
    rc = cli.main(json.loads(sys.argv[2]))
finally:
    sys.stdout.flush()
    distributed.shutdown()
raise SystemExit(rc)
"""


def cli_world(argv: list, out: Path, n: int = 2, sigint_rank=None,
              snapshot=None, timeout_s: float = 300) -> list:
    """``n`` ranks of the CLI (``CLI_RANK_CHILD``) on card 0; with
    ``sigint_rank``, that rank alone gets a SIGINT once ``snapshot``'s
    first integrity file landed.  Returns each rank's ``(exit code,
    stdout)``; a join past the time limit fails the smoke."""
    import signal
    import socket

    out.mkdir(parents=True, exist_ok=True)
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    procs, files = [], []
    for r in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   GROUP_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        fo, fe = open(out / f"rank{r}.out", "wb"), open(out / f"rank{r}.log",
                                                         "wb")
        files += [fo, fe]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CLI_RANK_CHILD, str(ROOT),
             json.dumps(argv)], cwd=ROOT, env=env, stdout=fo, stderr=fe))
    deadline = time.monotonic() + timeout_s
    try:
        if sigint_rank is not None:
            while procs[sigint_rank].poll() is None \
                    and time.monotonic() < deadline:
                if os.path.exists(snapshot + ".sum"):
                    procs[sigint_rank].send_signal(signal.SIGINT)
                    break
                time.sleep(0.002)
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise SystemExit(f"the CLI world of {n} ranks outlived "
                         f"{timeout_s} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        for f in files:
            f.close()
    return [(p.returncode, (out / f"rank{r}.out").read_bytes())
            for r, p in enumerate(procs)]


def many_ranks_phase(by_path: dict, tmp: Path, path: Path,
                     stream_data: bytes, want_words: dict, ngram_want,
                     dev) -> None:
    """Phase 11: the streamed run over several ranks (see the module
    docstring).  Returns the one-rank runs the worlds were held to."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mapreduce_tpu_torch import Config, cli, count_file
    from mapreduce_tpu_torch.data import reader as reader_mod
    from mapreduce_tpu_torch.models import grep
    from mapreduce_tpu_torch.runtime import checkpoint as ckpt_mod

    t_phase = time.perf_counter()
    cfg = Config()
    w = cfg.pallas_max_token
    n_cards = torch.cuda.device_count()
    emit("many_ranks", cuda_device_count=n_cards, card=card_name())
    patterns = ["the", "er", "and", "\nt"]
    k = 4096
    # The first run of a process pays its warm-up (the caching
    # allocator's first blocks, first launches): a tree run, checked like
    # the others, takes it, so the strategies' finishes compare.
    cases = [{"name": f"count_file_{s}", "kind": "count_file",
              "args": {"strategy": s.split("_")[0]}}
             for s in ("tree_warmup", "tree", "gather", "keyrange")]
    cases += [{"name": "count_file_ngram2", "kind": "count_file",
               "args": {"strategy": "tree", "ngram": 2}},
              {"name": "grep_file_p4", "kind": "grep",
               "args": {"patterns": patterns}},
              {"name": "sample_file_k4096", "kind": "sample",
               "args": {"k": k}}]
    # The one-rank runs the worlds are held to, here on the card.
    one = {"count": count_file(str(path), cfg),
           "ngram2": count_file(str(path), cfg, ngram=2),
           "grep": [(r.matches, r.lines) for r in grep.grep_file_multi(
               str(path), [p.encode() for p in patterns], cfg)]}
    if one["ngram2"].as_dict() != ngram_want[0] \
            or one["ngram2"].total != ngram_want[1]:
        raise SystemExit("one-rank bigrams differ from the oracle")
    arr = np.frombuffer(stream_data, np.uint8)
    nlpos = np.flatnonzero(arr == 0x0A)
    spans = token_spans(stream_data)
    # The 8-file corpus's one-rank runs, held to the oracle: every file is
    # cut alike, so the word and gram counts, the dropped occurrences and
    # grep's matches and lines are 8 times one file's.
    corpus8 = [str(path)] * 8
    cuts1 = np.stack([b.base_offsets for b in reader_mod.iter_batches(
        str(path), 1, cfg.chunk_bytes)]).ravel()[1:]
    grep1 = []
    for p in patterns:
        hits = pattern_hits(arr, literal_luts(p.encode()), cuts1)
        grep1.append((len(hits), matching_lines(hits, nlpos)))
    one8 = count_file(corpus8, cfg)
    one8_ng = count_file(corpus8, cfg, ngram=2)
    ref8 = {"count1": result_fields(one["count"]),
           "count8": result_fields(one8), "ngram8": result_fields(one8_ng),
           "grep8": [(r.matches, r.lines) for r in grep.grep_file_multi(
               corpus8, [p.encode() for p in patterns], cfg)]}
    if one["count"].as_dict() != want_words \
            or list(one["count"].words) != list(want_words) \
            or one8.as_dict() != {k: 8 * v for k, v in want_words.items()} \
            or list(one8.words) != list(want_words) \
            or one8_ng.as_dict() != {k: 8 * v
                                     for k, v in ngram_want[0].items()} \
            or (one8_ng.total, one8_ng.dropped_count) != (
                8 * ngram_want[1], 8 * ngram_want[2]) \
            or ref8["grep8"] != [(8 * m, 8 * n_) for m, n_ in grep1] \
            or one["grep"] != grep1:
        raise SystemExit("the one-rank runs over 8 files differ from the "
                         "oracle")

    worlds = [("nccl", max(1, min(n_cards, 4))), ("gloo", 2)]
    # The gloo world also stages its batch tables (merge_every=4): the
    # tree finish flushes both operands' staged rows.
    staged = {"name": "count_file_tree_merge_every4", "kind": "count_file",
              "args": {"strategy": "tree", "merge_every": 4}}
    for backend, n in worlds:
        t_w = time.perf_counter()
        new = rank_cases(("tree", "gather", "keyrange"), patterns, True, n)
        cases_w = cases + ([staged] if backend == "gloo" else [])
        ranks = run_world(n, backend, {"path": str(path),
                                       "cases": cases_w + new},
                          tmp / f"world_{backend}{n}")
        world_s = time.perf_counter() - t_w
        # The reader's cuts of n rows a step: the oracles' row starts.
        bases = np.stack([b.base_offsets for b in reader_mod.iter_batches(
            str(path), n, cfg.chunk_bytes)])
        head = ranks[0]["cases"]
        new_cases = hold_rank_cases(f"{backend}{n}", new, ranks,
                                    bases.shape[0], ref8, ngram_want,
                                    8 * len(stream_data))
        for name in [c["name"] for c in cases_w]:
            case = head[name]
            if np.asarray(case["bases"]).tolist() != bases.tolist():
                raise SystemExit(f"{backend}{n} {name}: row bases differ "
                                 "from the reader's cuts")
            for r in ranks:
                mine = r["cases"][name]
                if r["rank"] and mine["result"] is not None \
                        and name != "grep_file_p4":
                    raise SystemExit(f"{name}: rank {r['rank']} returned a "
                                     "result")
        # Word count and bigrams: field by field against one rank's run,
        # and the words (grams) against the oracle (``hold_count``).
        for name, ref, oracle_words, ng in (
                ("count_file_tree_warmup", "count", want_words, None),
                ("count_file_tree", "count", want_words, None),
                ("count_file_gather", "count", want_words, None),
                ("count_file_keyrange", "count", want_words, None),
                ("count_file_ngram2", "ngram2", ngram_want[0], ngram_want),
                *([("count_file_tree_merge_every4", "count", want_words,
                    None)] if backend == "gloo" else [])):
            hold_count(f"{backend}{n} {name}", head[name]["result"],
                       one[ref], oracle_words, ng)
        cuts = bases.ravel()[1:]
        want_grep = []
        for p in patterns:
            hits = pattern_hits(arr, literal_luts(p.encode()), cuts)
            want_grep.append((len(hits), matching_lines(hits, nlpos)))
        for r in ranks:
            got_g = [tuple(x) for x in r["cases"]["grep_file_p4"]["result"]]
            if got_g != want_grep or got_g != one["grep"]:
                raise SystemExit(f"{backend}{n} grep on rank {r['rank']}: "
                                 f"{got_g}, oracle {want_grep}, one rank "
                                 f"{one['grep']}")
        cands, population = sample_candidates(spans, bases.ravel(), 0, k, w)
        s_, e_ = bottom_k([cands], k)
        want_sample = [stream_data[a:b] for a, b in zip(s_.tolist(),
                                                        e_.tolist())]
        got = head["sample_file_k4096"]["result"]
        if [bytes.fromhex(x) for x in got["tokens"]] != want_sample \
                or got["total"] != population:
            raise SystemExit(f"{backend}{n} sample differs from the oracle")
        # Launches: every rank maps one chunk a step (a row past the end
        # is an empty chunk): the word count's compact mode, the bigrams'
        # and the sample's pair mode, grep none.
        steps = bases.shape[0]
        need = {"count_file_tree_warmup": "tokenize_compact",
                "count_file_tree": "tokenize_compact",
                "count_file_gather": "tokenize_compact",
                "count_file_keyrange": "tokenize_compact",
                "count_file_tree_merge_every4": "tokenize_compact",
                "count_file_ngram2": "tokenize_pair",
                "sample_file_k4096": "tokenize_pair"}
        for r in ranks:
            for name in [c["name"] for c in cases_w]:
                case = r["cases"][name]
                want_l = {need[name]: steps} if name in need else {}
                if case["launches"] != want_l:
                    raise SystemExit(f"{backend}{n} {name} rank {r['rank']} "
                                     f"launched {case['launches']}, "
                                     f"expected {want_l}")
        for name, case in head.items():
            by_path[f"ranks_{backend}{n}_{name}"] = case["launches"]
        emit("many_ranks", backend=backend, ranks=n,
             devices=sorted({r["device"] for r in ranks}),
             transport="host" if backend == "gloo" else "device",
             bytes=len(stream_data), steps=steps, world_s=round(world_s, 3),
             equal_to_one_rank_and_oracle=True,
             cases={name: {
                 "seconds": [round(r["cases"][name]["seconds"], 4)
                             for r in ranks],
                 "finish_ms": [round(r["cases"][name]["reduce_s"] * 1e3, 3)
                               for r in ranks],
                 "bytes_sent_per_rank": [r["cases"][name]["bytes_sent"]
                                         for r in ranks],
                 "launches_per_rank": [r["cases"][name]["launches"]
                                       for r in ranks]}
                 for name in head},
             all_gather_ms={key[len("all_gather_ms_"):]: [
                 round(r[key], 4) for r in ranks]
                 for key in ranks[0] if key.startswith("all_gather_ms_")})
        # Window-boundary merges, GB/s in turns, replay and the ladder
        # across the ranks; a tree partial moves what a finish moves.
        partials = new_cases["overlap_tree"]["partials_predicted"]
        emit("many_ranks", backend=backend, ranks=n, corpus_files=8,
             bytes=8 * len(stream_data), window=cfg.inflight_groups,
             tree_bytes_predicted_per_rank=(partials + 1) * 14_680_096
             if n == 2 else 0, new_cases=new_cases,
             gb_per_s={arm: [c["gb_per_s"] for name, c in new_cases.items()
                             if name.endswith("_" + arm)]
                       for arm in ("on", "off", "retry1", "retry0")})

    # A real SIGINT to one rank of a 2-rank CLI world on card 0, once the
    # first snapshot landed: every rank must drain at the same step and
    # exit 75, and the relaunch print what one uninterrupted rank prints.
    t_c = time.perf_counter()
    argv = [*corpus8, "--stream", "--no-echo", "--format", "json"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli.main(argv) != 0:
            raise SystemExit("the uninterrupted CLI run failed")
    want_out = buf.getvalue().encode()
    ck = str(tmp / "ranks_sigint.npz")
    argv += ["--checkpoint", ck, "--checkpoint-every", "2"]
    first = cli_world(argv, tmp / "ranks_cli_sigint", sigint_rank=1,
                      snapshot=ck)
    if first != [(75, b""), (75, b"")]:
        raise SystemExit(
            f"the SIGINT'd CLI world ended "
            f"{[(rc, len(o)) for rc, o in first]}: "
            + (tmp / "ranks_cli_sigint" / "rank0.log").read_text(
                errors="replace")[-3000:])
    _, step, offset, _, _ = ckpt_mod.load(ck)
    again = cli_world(argv, tmp / "ranks_cli_resume")
    if again != [(0, want_out), (0, b"")]:
        raise SystemExit(f"the relaunched CLI world ended "
                         f"{[(rc, len(o)) for rc, o in again]}, rank 0's "
                         f"stdout equal {again[0][1] == want_out}")
    emit("many_ranks", case="cli_sigint", ranks=2, backend="gloo",
         signalled_rank=1, exits=[75, 75], snapshot_step=step,
         snapshot_offset=offset, preempted_lines=[
             ln for r in range(2) for ln in (
                 tmp / "ranks_cli_sigint" / f"rank{r}.log").read_text(
                 errors="replace").splitlines()
             if ln.startswith("preempted:")],
         relaunch_equal_to_uninterrupted=True,
         seconds=round(time.perf_counter() - t_c, 3))
    emit("many_ranks", phase_s=round(time.perf_counter() - t_phase, 3))
    return one, ref8


# Phase 12's child: one rank of a world laid out as hosts (nodes) of
# ranks.  Every case's measurements are written after the case, so a
# planned process-kill (the last case) leaves the earlier ones on disk.
MANY_HOSTS_CHILD = """
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
spec = json.loads(sys.argv[2])
import torch
from mapreduce_tpu_torch import Config, count_file
from mapreduce_tpu_torch.models import grep
from mapreduce_tpu_torch.models.wordcount import WordCountJob
from mapreduce_tpu_torch.obs import registry
from mapreduce_tpu_torch.obs.telemetry import Telemetry
from mapreduce_tpu_torch.ops import table as table_ops
from mapreduce_tpu_torch.ops.cuda import tokenize as ktok
from mapreduce_tpu_torch.parallel import collectives, distributed
from mapreduce_tpu_torch.parallel.mesh import two_level_mesh
from mapreduce_tpu_torch.runtime import executor

from chip_smoke import rank_case

dev = distributed.initialize("gpu", backend=spec["backend"], timeout_s=120)
hosts, local = distributed.process_count(), distributed.local_device_count()
mesh = two_level_mesh(hosts, local, device=dev)
path, cfg = spec["path"], Config()
runs = []
real_run_job = executor.run_job

def kept_run_job(*a, **kw):
    runs.append(real_run_job(*a, **kw))
    return runs[-1]

executor.run_job = kept_run_job

def sent():
    snap = registry.get_registry().snapshot()["counters"]
    return {k: v for k, v in snap.items()
            if k.startswith("collectives.bytes_sent")}

def fields(r):
    return None if r is None else {"words": [w.hex() for w in r.words],
        "counts": r.counts, "total": r.total, "distinct": r.distinct,
        "dropped_uniques": r.dropped_uniques,
        "dropped_count": r.dropped_count}

out = {"rank": mesh.rank, "host": distributed.process_index(),
       "hosts": hosts, "local": local, "device": str(dev),
       "outer_ranks": list(mesh.outer.ranks),
       "inner_ranks": list(mesh.inner.ranks), "cases": {}}
dst = os.path.join(spec["out"], f"rank{mesh.rank}.json")
for case in spec["cases"]:
    kind, args = case["kind"], case["args"]
    torch.cuda.synchronize(dev)
    torch.distributed.barrier()
    ktok.LAUNCHES.clear()
    runs.clear()
    before = sent()
    t0 = time.perf_counter()
    extra = {}
    if kind == "count_file":
        res = fields(count_file(path, Config(merge_strategy=args["strategy"]),
                                dev, mesh=mesh, ngram=args.get("ngram", 1)))
    elif kind == "grep":
        res = [(x.matches, x.lines) for x in grep.grep_file_multi(
            path, [p.encode() for p in args["patterns"]], cfg, dev,
            mesh=mesh)]
    elif kind in ("overlap", "replay", "storm"):
        res, extra = rank_case(kind, dict(args, name=case["name"]), spec,
                               dev, mesh, runs)
    elif kind == "host_range":
        # Mode (a): this host's aligned range over its own ranks; then
        # the hosts' partial tables merged by a tree across hosts.
        lo, hi = distributed.align_range_to_separator(
            path, *distributed.host_byte_range(os.path.getsize(path)))
        res = fields(count_file(path, cfg, dev,
                                mesh=distributed.local_data_mesh(device=dev),
                                byte_range=(lo, hi)))
        merged = collectives.tree_merge(
            runs[-1].value, lambda a, b: table_ops.merge(
                a, b, capacity=cfg.table_capacity), mesh.outer)
        extra = {"range": [lo, hi], "merged_total": merged.total_count(),
                 "merged_distinct": int(merged.occupied().sum()),
                 "merged_dropped": list(merged.dropped_totals())}
    else:  # the global driver, with a ledger, a snapshot, a fault plan
        overlap = args.get("overlap", False)
        c = Config(fault_plan=args.get("fault_plan"), merge_overlap=overlap,
                   inflight_groups=1 if overlap else 4)
        tel = (Telemetry.create(ledger_path=args["ledger"],
                                progress_every_s=3600)
               if args.get("ledger") else None)
        try:
            rr = executor.run_job_global(
                WordCountJob(c, dev), path, c,
                mesh=mesh if args.get("two_level") else None,
                checkpoint_path=args.get("checkpoint"),
                checkpoint_every=args.get("every", 0), telemetry=tel)
        finally:
            if tel is not None:
                tel.close()
        runs.append(rr)
        res = (fields(executor.recover_from_file(
            rr.value, path, rr.bases, rr.bases.shape[1]))
               if mesh.rank == 0 else None)
    seconds = time.perf_counter() - t0
    after = sent()
    rr = runs[-1]
    out["cases"][case["name"]] = {
        "seconds": seconds, "result": res, **extra,
        "reduce_s": rr.metrics.phases.get("reduce"),
        "steps": int(rr.bases.shape[0]), "bases": rr.bases.tolist(),
        "launches": dict(ktok.LAUNCHES),
        "bytes_sent": {k: after[k] - before.get(k, 0) for k in after
                       if after[k] != before.get(k, 0)}}
    with open(dst, "w") as f:
        json.dump(out, f)
distributed.shutdown()
"""


def many_hosts_phase(by_path: dict, tmp: Path, path: Path,
                     stream_data: bytes, want_words: dict, ngram_want,
                     one: dict, ref: dict) -> None:
    """Phase 12: the streamed run over several hosts (see the module
    docstring).  ``one`` holds phase 11's one-rank runs on the card,
    ``ref`` its 8-file ones."""
    import numpy as np
    import torch

    from mapreduce_tpu_torch import Config
    from mapreduce_tpu_torch.data import reader as reader_mod
    from mapreduce_tpu_torch.obs import ledger

    t_phase = time.perf_counter()
    cfg = Config()
    n_cards = torch.cuda.device_count()
    patterns = ["the", "er", "and", "\nt"]
    strategies = ("tree", "gather", "keyrange", "hier-tree-tree",
                  "hier-kr-tree")
    led = str(tmp / "hosts_ledger.jsonl")
    ck = str(tmp / "hosts_global.npz")
    for old in tmp.glob("hosts_*"):  # a snapshot would be resumed
        if old.is_file():
            old.unlink()
    cases = [{"name": f"count_file_{s}", "kind": "count_file",
              "args": {"strategy": s.split("_")[0]}}
             for s in ("tree_warmup",) + strategies]
    cases += [{"name": "count_file_ngram2", "kind": "count_file",
               "args": {"strategy": "tree", "ngram": 2}},
              {"name": "grep_file_p4", "kind": "grep",
               "args": {"patterns": patterns}},
              {"name": "host_range", "kind": "host_range", "args": {}},
              {"name": "global", "kind": "global",
               "args": {"ledger": led}},
              {"name": "global_hier", "kind": "global",
               "args": {"two_level": True}}]
    # The kill lands after the first step's checkpoint boundary, where a
    # window of one merged a partial into the snapshot's accumulator; the
    # resume merges the snapshot's accumulator and the residual.
    kill = {"name": "global_kill", "kind": "global",
            "args": {"checkpoint": ck, "every": 1, "overlap": True,
                     "fault_plan": "at=process-kill:1:permanent"}}
    resume = {"name": "global_resume", "kind": "global",
              "args": {"checkpoint": ck, "every": 1, "overlap": True}}
    arr = np.frombuffer(stream_data, np.uint8)
    nlpos = np.flatnonzero(arr == 0x0A)
    w_counts = sorted(want_words.values())
    # The gloo world: 2 hosts of 2 ranks on card 0 (NCCL refuses two
    # ranks on one card), whose last case kills every rank at the same
    # crossing; then a fresh world resumes.  The NCCL world: one host of
    # a card a rank.
    worlds = [("gloo", 4, 2), ("nccl", max(1, min(n_cards, 4)), 1)]
    for backend, n, hosts in worlds:
        t_w = time.perf_counter()
        label = f"{backend}{n}x{hosts}"
        # Phase 11's world of one rank ran every new case at D = 1 already:
        # the one-host world here adds the two-level overlaps only.
        new = [c for c in rank_cases(strategies, patterns, False, n)
               if hosts > 1 or c["name"].startswith("overlap_hier")]
        spec = {"path": str(path), "cases": cases + new
                + ([kill] if backend == "gloo" else [])}
        ranks = run_world(n, backend, spec, tmp / f"hosts_{label}",
                          child=MANY_HOSTS_CHILD, hosts=hosts,
                          expect_rc=113 if backend == "gloo" else 0)
        resumed = run_world(n, backend, {"path": str(path),
                                         "cases": [resume]},
                            tmp / f"hosts_{label}_resume",
                            child=MANY_HOSTS_CHILD, hosts=hosts) \
            if backend == "gloo" else None
        world_s = time.perf_counter() - t_w
        head = ranks[0]["cases"]
        bases = np.stack([b.base_offsets for b in reader_mod.iter_batches(
            str(path), n, cfg.chunk_bytes)])
        new_cases = hold_rank_cases(label, new, ranks, bases.shape[0], ref,
                                    ngram_want, 8 * len(stream_data))
        for r in ranks:
            if r["hosts"] != hosts or r["host"] != r["rank"] // (n // hosts):
                raise SystemExit(f"{label}: rank {r['rank']} is on host "
                                 f"{r['host']} of {r['hosts']}")
        for name in [c["name"] for c in cases if c["kind"] != "host_range"]:
            if np.asarray(head[name]["bases"]).tolist() != bases.tolist():
                raise SystemExit(f"{label} {name}: row bases differ from "
                                 "the reader's cuts")
        for s in ("tree_warmup",) + strategies:
            hold_count(f"{label} count_file_{s}",
                       head[f"count_file_{s}"]["result"], one["count"],
                       want_words)
        hold_count(f"{label} count_file_ngram2",
                   head["count_file_ngram2"]["result"], one["ngram2"],
                   ngram_want[0], ngram_want)
        cuts = bases.ravel()[1:]
        want_grep = []
        for p in patterns:
            hits = pattern_hits(arr, literal_luts(p.encode()), cuts)
            want_grep.append((len(hits), matching_lines(hits, nlpos)))
        for r in ranks:
            got_g = [tuple(x) for x in r["cases"]["grep_file_p4"]["result"]]
            if got_g != want_grep or got_g != one["grep"]:
                raise SystemExit(f"{label} grep on rank {r['rank']}: "
                                 f"{got_g}, oracle {want_grep}")
        # Mode (a): each host leader's partial words, summed over the
        # hosts, are the oracle's; the ranges tile the file; the tree of
        # partial tables across hosts holds every word once.
        local = n // hosts
        summed: dict = {}
        spans = []
        for r in ranks:
            case = r["cases"]["host_range"]
            spans.append(tuple(case["range"]))
            got = case["result"]
            if r["rank"] % local:
                if got is not None:
                    raise SystemExit(f"{label} host_range: rank "
                                     f"{r['rank']} returned a result")
                continue
            for wd, c in zip(got["words"], got["counts"]):
                summed[bytes.fromhex(wd)] = summed.get(
                    bytes.fromhex(wd), 0) + c
            if (case["merged_total"], case["merged_distinct"],
                    case["merged_dropped"]) != (
                    sum(w_counts), len(w_counts), [0, 0]):
                raise SystemExit(f"{label} host_range: merged table "
                                 f"{case['merged_total']} tokens, "
                                 f"{case['merged_distinct']} keys")
        tiles = sorted(set(spans))
        if summed != want_words or tiles[0][0] != 0 \
                or tiles[-1][1] != len(stream_data) \
                or any(a[1] != b[0] for a, b in zip(tiles, tiles[1:])):
            raise SystemExit(f"{label} host_range: the hosts' partial "
                             f"counts or ranges are not the corpus's: "
                             f"{tiles}")
        for name in ("global", "global_hier"):
            hold_count(f"{label} {name}", head[name]["result"],
                       one["count"], want_words)
        shards = {}
        if hosts > 1:
            for p in range(hosts):
                recs = list(ledger.read_ledger(ledger.shard_path(led, p)))
                kinds = [x["kind"] for x in recs]
                if any(x.get("host") != p for x in recs) \
                        or kinds[0] != "run_start" or kinds[-1] != "run_end" \
                        or recs[0].get("processes") != hosts:
                    raise SystemExit(f"{label}: shard {p} holds {kinds}")
                shards[p] = {"records": len(recs),
                             "groups": kinds.count("group"),
                             "host_bytes": sum(x.get("host_bytes", 0)
                                               for x in recs
                                               if x["kind"] == "group")}
            if sum(v["host_bytes"] for v in shards.values()) \
                    != len(stream_data):
                raise SystemExit(f"{label}: the shards' host_bytes do not "
                                 f"sum to the corpus: {shards}")
        if resumed is not None:
            kills = [r for r in ranks if "global_kill" in r["cases"]]
            if kills:
                raise SystemExit(f"{label}: the killed run finished")
            hold_count(f"{label} global_resume",
                       resumed[0]["cases"]["global_resume"]["result"],
                       one["count"], want_words)
        # Launches: every rank maps one chunk a step of each run: the
        # word count's compact mode, the bigrams' pair mode, grep none.
        need = {name: "tokenize_compact" for name in head
                if name.startswith(("count_file_", "global", "host_range"))}
        need["count_file_ngram2"] = "tokenize_pair"
        for r in ranks:
            for name in [c["name"] for c in cases]:
                case = r["cases"][name]
                want_l = {need[name]: case["steps"]} if name in need else {}
                if case["launches"] != want_l:
                    raise SystemExit(f"{label} {name} rank {r['rank']} "
                                     f"launched {case['launches']}, "
                                     f"expected {want_l}")
        for name, case in head.items():
            by_path[f"hosts_{label}_{name}"] = case["launches"]
        emit("many_hosts", backend=backend, ranks=n, hosts=hosts,
             mesh=[hosts, n // hosts], card=card_name(),
             transport="host" if backend == "gloo" else "device",
             bytes=len(stream_data), world_s=round(world_s, 3),
             equal_to_one_rank_and_oracle=True, shards=shards,
             killed_exit=113 if resumed is not None else None,
             cases={name: {
                 "seconds": [round(r["cases"][name]["seconds"], 4)
                             for r in ranks],
                 "finish_ms": [round((r["cases"][name]["reduce_s"] or 0)
                                     * 1e3, 3) for r in ranks],
                 "steps": head[name]["steps"],
                 "bytes_sent_per_rank": [r["cases"][name]["bytes_sent"]
                                         for r in ranks],
                 "launches_per_rank": [r["cases"][name]["launches"]
                                       for r in ranks]}
                 for name in [c["name"] for c in cases]})
        emit("many_hosts", backend=backend, ranks=n, hosts=hosts,
             corpus_files=8, bytes=8 * len(stream_data),
             window=cfg.inflight_groups, new_cases=new_cases,
             killed_after_partial=resumed is not None)
    emit("many_hosts", phase_s=round(time.perf_counter() - t_phase, 3))

# Phase 13's kill: a streamed run at ``merge_every=4`` with a snapshot a
# step, ended at the process-kill seam's second crossing, just after the
# snapshot of step 2 (two batches staged, none folded): argv = repo root,
# corpus file, checkpoint path.
KNOBS_KILL_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from mapreduce_tpu_torch import Config, count_file
cfg = Config(merge_every=4, inflight_groups=1,
             fault_plan="at=process-kill:2:transient")
count_file(sys.argv[2], cfg, checkpoint_path=sys.argv[3], checkpoint_every=1)
"""


def knobs_phase(drive, tmp: Path, path: Path, stream_data: bytes,
                want_stream: dict, words_data: bytes, want_words: dict,
                one_word32: bytes, dev) -> None:
    """Phase 13: the map's remaining knobs (see the module docstring)."""
    import collections
    import logging

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mapreduce_tpu_torch import (Config, Engine, MapReduceJob,
                                     count_file, count_words)
    from mapreduce_tpu_torch.models import wordcount as wc
    from mapreduce_tpu_torch.obs import ledger
    from mapreduce_tpu_torch.obs.telemetry import Telemetry
    from mapreduce_tpu_torch.ops import table as table_ops
    from mapreduce_tpu_torch.ops.cuda import radix
    from mapreduce_tpu_torch.ops.cuda import tokenize as ktok
    from mapreduce_tpu_torch.runtime import checkpoint as ckpt_mod

    t_phase = time.perf_counter()
    w = Config().pallas_max_token
    fields = ("words", "counts", "total", "distinct", "dropped_uniques",
              "dropped_count")

    def same(a, b) -> bool:
        return all(getattr(a, f) == getattr(b, f) for f in fields)

    def on_card(data: bytes) -> "torch.Tensor":
        return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)

    def step_turns(chunk, cfgs: dict, reps: int = 9) -> dict:
        """Median ms of one step (map + merge into an empty running
        table) of each configuration on ``chunk``, in turns."""
        running = table_ops.empty(Config().table_capacity, dev)
        times = {k: [] for k in cfgs}
        for rep in range(reps):
            order = list(cfgs) if rep % 2 else list(cfgs)[::-1]
            for name in order:
                c = cfgs[name]
                torch.cuda.synchronize()
                t_a = time.perf_counter()
                upd = wc._map_stream(chunk, c, c.batch_uniques, pos_hi=0)
                table_ops.merge(running, upd, capacity=c.table_capacity)
                torch.cuda.synchronize()
                if rep:
                    times[name].append((time.perf_counter() - t_a) * 1e3)
        return {k: round(statistics.median(v), 3) for k, v in times.items()}

    # 1. combiner='salt' on the one-word and the Zipf 32 MB corpora.  A
    # salted key spreads over up to 8 segments, and the batch table holds
    # segments: on the Zipf chunk they outnumber the default 2**18 slots,
    # where the cutoff falls on the salted order (the JAX envelope's
    # second leg), so its equality runs at 2**20 and the default is
    # measured beside it.
    one_want = dict(collections.Counter(one_word32.split()))
    corpora = {"one_word_32MB": (one_word32, one_want, Config().table_capacity),
               "zipf_32MB": (words_data, want_words, 1 << 20)}
    for label, (data, want, cap) in corpora.items():
        for impl in ("xla", "radix_partition"):
            need = {"tokenize_compact": 1}
            if impl != "xla":
                need.update(radix_partition=1, radix_sort=1)
            off, _ = drive(f"knobs_off_{label}_{impl}", lambda: count_words(
                data, Config(sort_impl=impl, table_capacity=cap)), want,
                need)
            got, seconds = drive(f"knobs_salt_{label}_{impl}",
                                 lambda: count_words(data, Config(
                                     combiner="salt", sort_impl=impl,
                                     table_capacity=cap)), want, need)
            if not same(got, off):
                raise SystemExit(f"salt on {label} ({impl}) differs from "
                                 "combiner='off'")
            emit("knobs", case="salt", corpus=label, sort_impl=impl,
                 table_capacity=cap, tokens=got.total,
                 distinct=got.distinct, seconds=round(seconds, 4),
                 equal_to_off_and_oracle=True)
        stream = ktok.tokenize_split_compact(on_card(data), w)[0].cut()
        live = stream.key_hi != ktok._SENT
        salted = torch.unique(table_ops._key64(
            stream.key_hi[live],
            stream.key_lo[live] ^ ((stream.packed[live] >> 6) & 7))).numel()
        del stream, live
        # At the default capacity: every occurrence is still accounted.
        spill = count_words(data, Config(combiner="salt"))
        if spill.total != sum(want.values()) or sum(spill.counts) \
                + spill.dropped_count != spill.total:
            raise SystemExit(f"salt at the default capacity lost tokens on "
                             f"{label}")
        chunk = on_card(data)
        emit("knobs", case="salt_step_ms", corpus=label,
             distinct=len(want), salted_segments=salted,
             default_capacity=Config().table_capacity,
             default_capacity_kept=len(spill.words),
             default_capacity_dropped_uniques=spill.dropped_uniques,
             default_capacity_dropped_count=spill.dropped_count,
             step_ms=step_turns(chunk, {
                 "off": Config(), "salt": Config(combiner="salt"),
                 "off_radix": Config(sort_impl="radix_partition"),
                 "salt_radix": Config(combiner="salt",
                                      sort_impl="radix_partition")}))
    # K2's seam on the one-word stream, salted as the build salts it.
    ow = ktok.tokenize_split_compact(on_card(one_word32), w)[0].cut()
    salted_lo = torch.where(ow.key_hi != ktok._SENT,
                            ow.key_lo ^ ((ow.packed >> 6) & 7), ow.key_lo)
    seam = {name: cuda_ms(lambda lo=lo: radix.radix_sort3(
        ow.key_hi, lo, ow.packed, impl="radix_partition",
        packed_ordered=True)) for name, lo in (("off", ow.key_lo),
                                                ("salt", salted_lo))}
    biggest = {}
    for name, lo in (("off", ow.key_lo), ("salt", salted_lo)):
        k = table_ops._key64(ow.key_hi, lo)
        biggest[name] = int(torch.unique(k, return_counts=True)[1].max())
    emit("knobs", case="salt_seam_ms", rows=int(ow.key_hi.shape[0]),
         seam_ms=seam, largest_segment_rows=biggest)
    del ow, salted_lo

    # 2. sort_mode='segmin': equal to stable2 without the rescue.
    plain = Config(rescue_overlong=0)
    ref = count_words(words_data, plain)
    got, seconds = drive("knobs_segmin", lambda: count_words(
        words_data, Config(sort_mode="segmin")), ref.as_dict(),
        {"tokenize_compact": 1}, total=ref.total)
    if not same(got, ref):
        raise SystemExit("segmin differs from stable2 without the rescue")
    chunk = on_card(words_data)
    seg_cfg = Config(sort_mode="segmin")
    step_ms = step_turns(chunk, {"stable2": plain,
                                 "sort3": Config(sort_mode="sort3",
                                                 rescue_overlong=0),
                                 "segmin": seg_cfg})
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            wc._map_stream(chunk, seg_cfg, seg_cfg.batch_uniques, pos_hi=0)
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total / 3e3)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total]
    scatter = [(k, ms) for k, ms in kernels if "scatter" in k.lower()]
    emit("knobs", case="segmin", tokens=got.total,
         dropped_count=got.dropped_count, seconds=round(seconds, 4),
         equal_to_stable2=True, step_ms=step_ms,
         device_ms_per_step=round(sum(ms for _, ms in kernels), 4),
         segmented_min_ms=round(sum(ms for _, ms in scatter), 4),
         segmented_min_kernels=[k[:60] for k, _ in scatter])
    del chunk

    # 3. merge_every=4 over the 8-file corpus, in turns.
    corpus8 = [str(path)] * 8
    want8 = {k: 8 * v for k, v in want_stream.items()}
    per_file = -(-len(stream_data) // Config().chunk_bytes)
    results = {}
    for i, k in enumerate((4, 1, 1, 4)):
        got, seconds = drive(f"knobs_merge_every{k}_turn{i}",
                             lambda k=k: count_file(corpus8, Config(
                                 merge_every=k)), want8,
                             {"tokenize_compact": 8 * per_file})
        results.setdefault(k, []).append(got)
        emit("knobs", case="merge_every", merge_every=k, turn=i,
             bytes=8 * len(stream_data), seconds=round(seconds, 4),
             gb_per_s=8 * len(stream_data) / seconds / 1e9,
             run_job_gb_per_s=got.run.metrics.gb_per_s,
             phases=got.run.metrics.phases)
    if not all(same(r, results[1][0]) for r in results[4] + results[1]):
        raise SystemExit("merge_every=4 differs from merge_every=1")
    # Killed just after a mid-buffer snapshot, then resumed.
    ck = tmp / "knobs_kill.npz"
    proc = subprocess.run([sys.executable, "-c", KNOBS_KILL_CHILD, str(ROOT),
                           str(path), str(ck)], capture_output=True,
                          timeout=300)
    if proc.returncode != 113:
        raise SystemExit(f"the merge_every kill ended {proc.returncode}: "
                         + proc.stderr.decode(errors="replace")[-3000:])
    leaves, step, offset, _, _ = ckpt_mod.load(str(ck))
    cursor = int(np.asarray(leaves[-1]).reshape(-1)[0])
    if not 0 < cursor < 4:
        raise SystemExit(f"the snapshot was not mid-buffer: cursor {cursor}")
    got, seconds = drive("knobs_merge_every_resumed", lambda: count_file(
        str(path), Config(merge_every=4, inflight_groups=1),
        checkpoint_path=str(ck), checkpoint_every=1), want_stream,
        {"tokenize_compact": per_file - step})
    emit("knobs", case="merge_every_kill", exit=proc.returncode,
         snapshot_step=step, snapshot_cursor=cursor, offset=offset,
         resumed_chunks=per_file - step, seconds=round(seconds, 4),
         equal_to_oracle=True)

    # 4. geometries: each equal to the default; the wrappers see the cache
    # depth and digit width the geometry names.
    seen: list = []
    real_sort, real_fused = radix.radix_sort3, ktok.tokenize_fused

    def sort_seen(*a, bits=radix.DEFAULT_BITS, **kw):
        seen.append(("bits", bits))
        return real_sort(*a, bits=bits, **kw)

    def fused_seen(*a, combiner_slots=0, **kw):
        seen.append(("combiner_slots", combiner_slots))
        return real_fused(*a, combiner_slots=combiner_slots, **kw)

    default = count_words(words_data, Config())
    geometries = {
        "combiner16": (Config(geometry="combiner16", map_impl="fused",
                              combiner="hot-cache"),
                       {"tokenize_combiner": 1}, ("combiner_slots", 16)),
        "tall512": (Config(geometry="tall512"), {"tokenize_compact": 1},
                    None),
        "radix_bits2": (Config(geometry={"radix_bits": 2},
                               sort_impl="radix_partition"),
                        {"tokenize_compact": 1, "radix_partition": 1,
                         "radix_sort": 1}, ("bits", 2)),
        "radix_bits5": (Config(geometry={"radix_bits": 5},
                               sort_impl="radix"),
                        {"tokenize_compact": 1, "radix_partition": 2,
                         "radix_sort": 1}, ("bits", 5)),
    }
    radix.radix_sort3, ktok.tokenize_fused = sort_seen, fused_seen
    try:
        for name, (c, need, arg) in geometries.items():
            seen.clear()
            got, seconds = drive(f"knobs_geometry_{name}",
                                 lambda c=c: count_words(words_data, c),
                                 want_words, need)
            if not same(got, default) or seen != ([arg] if arg else []):
                raise SystemExit(f"geometry {name}: equal to the default "
                                 f"{same(got, default)}, wrapper arguments "
                                 f"{seen}")
            emit("knobs", case="geometry", geometry=name,
                 label=c.geometry_label, wrapper_arguments=seen[:],
                 seconds=round(seconds, 4), equal_to_default=True)
    finally:
        radix.radix_sort3, ktok.tokenize_fused = real_sort, real_fused
    for c in (Config(geometry="tall512"),
              Config(geometry={"radix_bits": 2},
                     sort_impl="radix_partition")):
        led = tmp / "knobs_geometry.jsonl"
        if led.exists():
            led.unlink()
        tel = Telemetry.create(ledger_path=str(led))
        try:
            got = count_file(str(path), c, telemetry=tel)
        finally:
            tel.close()
        start = [r for r in ledger.read_ledger(str(led))
                 if r["kind"] == "run_start"][0]
        want_spec = c.resolved_geometry.as_dict() \
            if c.geometry_label == "custom" else None
        if got.as_dict() != want_stream or start["geometry"] \
                != c.geometry_label \
                or start.get("geometry_spec") != want_spec:
            raise SystemExit(f"run_start of {c.geometry_label}: {start}")
        emit("knobs", case="run_start", geometry=start["geometry"],
             geometry_spec=start.get("geometry_spec"))
    storm = Config(geometry="tall512", inflight_groups=1,
                   fault_plan="at=dispatch:1:resource,at=dispatch:2:resource",
                   failure_policy={"transient_retries": 1,
                                   "resource_retries": 0,
                                   "backoff_base_s": 0.0})
    got, seconds = drive("knobs_geometry_storm", lambda: count_file(
        str(path), storm), want_stream, {"tokenize_compact": None})
    steps = got.run.pipeline.get("degrade_steps")
    if steps != ["revert-geometry"]:
        raise SystemExit(f"the storm at tall512 walked {steps}")
    emit("knobs", case="geometry_storm", degrade_steps=steps,
         seconds=round(seconds, 4), equal_to_oracle=True)

    # 5. a user's job: the byte-class histogram through the Engine.
    class ByteClassHistogramJob(MapReduceJob):
        def init_state(self):
            return torch.zeros(4, dtype=torch.int64, device=dev)

        def map_chunk(self, chunk, chunk_id):
            low = chunk | 0x20
            letter = (low >= ord("a")) & (low <= ord("z"))
            digit = (chunk >= ord("0")) & (chunk <= ord("9"))
            space = (chunk == 0x20) | ((chunk >= 0x09) & (chunk <= 0x0D))
            other = ~(letter | digit | space | (chunk == 0))
            return torch.stack([x.sum() for x in (letter, digit, space,
                                                  other)])

        def combine(self, state, update):
            return state + update

        def merge(self, a, b):
            return a + b

    arr = np.frombuffer(words_data, np.uint8)
    low = arr | 0x20
    letter = (low >= 97) & (low <= 122)
    digit = (arr >= 48) & (arr <= 57)
    space = (arr == 0x20) | ((arr >= 9) & (arr <= 13))
    want_hist = [int(letter.sum()), int(digit.sum()), int(space.sum()),
                 int((~(letter | digit | space | (arr == 0))).sum())]
    ktok.LAUNCHES.clear()
    engine = Engine(ByteClassHistogramJob(), dev)
    rows = arr.reshape(4, -1).copy()
    t_a = time.perf_counter()
    hist = engine.run(rows[i:i + 1] for i in range(4)).cpu().tolist()
    seconds = time.perf_counter() - t_a
    if hist != want_hist or ktok.LAUNCHES:
        raise SystemExit(f"the custom job counted {hist}, numpy "
                         f"{want_hist}; launches {dict(ktok.LAUNCHES)}")
    emit("knobs", case="custom_job", hist=hist, steps=4,
         seconds=round(seconds, 4), equal_to_numpy=True)
    emit("knobs", phase_s=round(time.perf_counter() - t_phase, 3))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); this script measures the port on the card only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    t_mark = [t_start]

    def mark(phase: str) -> None:
        """The wall seconds of the phase that just ended."""
        now = time.perf_counter()
        emit("phase_time", name=phase, seconds=round(now - t_mark[0], 3))
        t_mark[0] = now

    sys.path.insert(0, str(ROOT))
    import numpy as np

    from mapreduce_tpu_torch import Config, count_file, count_words, native
    from mapreduce_tpu_torch.models import wordcount as wc
    from mapreduce_tpu_torch.ops import table as table_ops
    from mapreduce_tpu_torch.ops.cuda import _build
    from mapreduce_tpu_torch.ops.cuda import radix
    from mapreduce_tpu_torch.ops.cuda import tokenize as ktok

    dev = torch.device("cuda")
    cfg = Config()
    w = cfg.pallas_max_token
    cslots = Config(map_impl="fused", combiner="hot-cache") \
        .resolved_combiner_slots
    modes = {
        "tokenize_compact": lambda t, w: ktok.tokenize_split_compact(t, w),
        "tokenize_pair": lambda t, w: (*ktok.tokenize_split(t, w), None),
        "tokenize_fused": lambda t, w: ktok.tokenize_fused(
            t, max_token_bytes=w),
    }
    errs = {k: 0 for k in ("tokenize_compact", "tokenize_pair",
                           "tokenize_fused", "tokenize_combiner",
                           "radix_partition", "radix_sort")}

    def on_card(data: bytes) -> torch.Tensor:
        return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)

    # 1. build: every kernel source, in parallel, and the host chunker
    t0 = time.perf_counter()
    built = _build.build_all()
    native.load()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         libraries={k: str(p.relative_to(ROOT)) for k, (p, _) in built.items()},
         native_chunker=str(native.library_path().relative_to(ROOT)),
         ptxas={k: [ln for ln in r.splitlines() if "ptxas info" in ln
                    and ("Used" in ln or "Function properties" in ln)][-6:]
                for k, (_, r) in built.items()})
    mark("build")

    # 2. the wrappers the main paths call against the plain versions
    # (launches here do not count: the counters are cleared after)
    chunk32 = make_corpus(32 * MB, SEED, dense_at=None)
    one_word32 = one_word_corpus(32 * MB, SEED + 5)
    edges = edge_chunk(4 * MB + 77, w, ktok.TILE)
    probes = {
        "zipf_32MB": (chunk32, w),
        "dense": (b"a b " * (MB // 4), w),
        "edges": (edges, w),
        "edges_w1": (edges, 1),
        "edges_w63": (edges, 63),
        "min_chunk": (make_corpus(cfg.pallas_min_chunk, SEED + 1), w),
        "separators": (b" \n\t " * (MB // 4), w),
        "max_chunk_64MB": (chunk32 * 2, w),  # 2**26 bytes, the limit
        "one_word_32MB": (one_word32, w),
    }
    for name, (data, pw) in probes.items():
        t = on_card(data)
        want, want_over, want_spill = ktok.tokenize_stream_plain(t, pw)
        for mode, wrapper in modes.items():
            stream, over, spill = wrapper(t, pw)
            if spill is None:  # pair mode returns none: the plain one's
                spill = want_spill
            cut = stream.cut()
            err = max_err((want.key_hi, want.key_lo, want.packed, want.total,
                           want.live, want_over, want_spill),
                          (cut.key_hi, cut.key_lo, cut.packed, cut.total,
                           stream.live, over, spill))
            errs[mode] = max(errs[mode], err)
            if err:
                raise SystemExit(f"kernel {mode} differs from its plain "
                                 f"version on {name}: {err}")
            live, over, spill = (int(x) for x in (stream.live, over, spill))
            emit("kernel", probe=name, mode=mode, bytes=len(data), w=pw,
                 live=live, overlong=over, tokens=int(cut.total),
                 spill=spill, rows_allocated=stream.packed.shape[0],
                 equal=True)
            if spill:
                raise SystemExit(f"{mode} spilled on {name}")
            if name == "separators" and live:
                raise SystemExit("the separator chunk has live rows")
        del t, want

    # K1d: the combiner kernel against its plain version.  The edge chunk's
    # segments are 11 combiner windows, so every segment edge is a window
    # edge and carries a run across it.
    n_edge = ktok.SEGMENTS * 11 * ktok.WINDOW
    n_pairs = ktok.SEGMENTS * 3 * ktok.WINDOW  # three full windows a segment
    comb_probes = {
        "zipf_32MB": chunk32,
        "dense_ab": probes["dense"][0],
        "dense_pairs_spills": (PAIRS * (n_pairs // len(PAIRS) + 1))[:n_pairs],
        "edges": edge_chunk(n_edge, w, ktok.WINDOW),
        "single_key_4MB": b"hot " * MB,
        "one_word_32MB": one_word32,
    }
    comb_counts = {}
    for name, data in comb_probes.items():
        t = on_card(data)
        want = ktok.tokenize_combiner_plain(t, w, ktok.COMBINER_SLOTS, cslots)
        got = ktok.tokenize_fused(t, max_token_bytes=w, combiner_slots=cslots)
        got = (got[0].key_hi, got[0].key_lo, got[0].packed, got[1],
               got[0].total, got[2], *got[3])
        err = max_err((*want[:6], *want[6]), got)
        errs["tokenize_combiner"] = max(errs["tokenize_combiner"], err)
        if err:
            raise SystemExit(f"combiner kernel differs from its plain "
                             f"version on {name}: {err}")
        over, ntok, spill = (int(x) for x in got[3:6])
        hits = int(got[8].sum())
        flushes = int((got[8] > 0).sum())
        comb_counts[name] = {"tokens_left": ntok, "hits": hits,
                             "flush_rows": flushes,
                             "stream_rows": got[0].shape[0]}
        emit("kernel", probe=name, mode="tokenize_combiner", bytes=len(data),
             overlong=over, spill=spill, **comb_counts[name], equal=True)
        if (spill > 0) != (name == "dense_pairs_spills"):
            raise SystemExit(f"combiner spill {spill} on {name}")
        if name == "single_key_4MB" and ntok:
            raise SystemExit("single-key chunk left tokens in the stream")
        if name not in ("zipf_32MB", "one_word_32MB"):
            continue
        # Each launch on its own against its plain version, same inputs.
        heads, scratch = ktok.combiner_heads_kernel(t, w, cslots)
        cache = ktok.combiner_merge_kernel(heads, t.shape[0], cslots)
        thin = ktok.combiner_thin_kernel(
            t.shape[0], ktok.COMBINER_SLOTS,
            cache._replace(count=cache.count.clone()), scratch)
        err = max(max_err(ktok.combiner_heads_plain(t, w, cslots), heads),
                  max_err(ktok.combiner_merge_plain(heads, cslots), cache),
                  max_err(ktok.combiner_thin_plain(t, w, ktok.COMBINER_SLOTS,
                                                   cache), thin))
        errs["tokenize_combiner"] = max(errs["tokenize_combiner"], err)
        if err:
            raise SystemExit(f"a combiner phase differs from its plain "
                             f"version on {name}: {err}")
        emit("kernel", probe=name, mode="tokenize_combiner",
             phases=["heads", "merge", "thin"], equal=True)
        # The cache depths a geometry or ``combiner_slots`` picks: the
        # whole kernel and each launch against the plain versions.
        for depth in (16, 24, 32):
            want = ktok.tokenize_combiner_plain(t, w, ktok.COMBINER_SLOTS,
                                                depth)
            got = ktok.tokenize_fused(t, max_token_bytes=w,
                                      combiner_slots=depth)
            err = max_err((*want[:6], *want[6]),
                          (got[0].key_hi, got[0].key_lo, got[0].packed,
                           got[1], got[0].total, got[2], *got[3]))
            heads, scratch = ktok.combiner_heads_kernel(t, w, depth)
            cache = ktok.combiner_merge_kernel(heads, t.shape[0], depth)
            thin = ktok.combiner_thin_kernel(
                t.shape[0], ktok.COMBINER_SLOTS,
                cache._replace(count=cache.count.clone()), scratch)
            err = max(err, max_err(ktok.combiner_heads_plain(t, w, depth),
                                   heads),
                      max_err(ktok.combiner_merge_plain(heads, depth),
                              cache),
                      max_err(ktok.combiner_thin_plain(
                          t, w, ktok.COMBINER_SLOTS, cache), thin))
            errs["tokenize_combiner"] = max(errs["tokenize_combiner"], err)
            if err:
                raise SystemExit(f"the combiner at depth {depth} differs "
                                 f"from its plain version on {name}: {err}")
            emit("kernel", probe=name, mode="tokenize_combiner",
                 combiner_slots=depth, hits=int(got[3].count.sum()),
                 phases=["whole", "heads", "merge", "thin"], equal=True)

    # K2: the radix seam, each launch kind and both impls, against the
    # plain versions and the 3-key sort.
    k1a = ktok.tokenize_split_compact(on_card(chunk32), w)[0].cut()
    rows = (k1a.key_hi, k1a.key_lo, k1a.packed)
    live = ~((rows[0] == ktok._SENT) & (rows[1] == ktok._SENT))
    one_word = ktok.tokenize_split_compact(on_card(one_word32), w)[0].cut()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_rand = 4 * MB

    def rand_keys(lo_bound):
        return torch.randint(lo_bound, (1 << 32) - 1, (n_rand,), device=dev,
                             generator=gen)

    hot = torch.rand(n_rand, device=dev, generator=gen) < 0.6
    rand_pk = torch.randperm(n_rand, device=dev, generator=gen) << 6 | 5
    radix_probes = {
        "k1a_stream_32MB": (rows, True),
        "one_word_stream_32MB": ((one_word.key_hi, one_word.key_lo,
                                  one_word.packed), True),
        "one_bucket": ((torch.where(live, 0x8765_4321, rows[0]), *rows[1:]),
                       True),
        "random_high_keys": ((rand_keys(1 << 31), rand_keys(0), rand_pk),
                             False),
        "random_hot_key": ((torch.where(hot, 0xC0DE_0001, rand_keys(0)),
                            torch.where(hot, 0x0BAD_F00D, rand_keys(0)),
                            rand_pk), False),
        "all_dead": (tuple(torch.full((MB,), ktok._SENT, dtype=torch.int64,
                                      device=dev) for _ in range(3)), True),
    }
    bits = radix.DEFAULT_BITS
    for name, (planes, ordered) in radix_probes.items():
        # Each level on its own against the plain partition, row for row
        # (both are stable); the second level reads the first level's
        # kernel output.  Then the segmented sort of the plain partition.
        level_in, ends = planes, None
        for level in (1, 2):
            shift = 32 - level * bits
            want = radix.partition_level_plain(*level_in, shift, bits, ends)
            got = radix.partition_level(*level_in, shift, bits, ends)
            err = max_err((want[1], *want[0]), (got[1], *got[0]))
            errs["radix_partition"] = max(errs["radix_partition"], err)
            if err:
                raise SystemExit(f"radix level {level} differs from the "
                                 f"plain partition on {name}: {err}")
            sort_err = max_err(
                radix.segmented_sort_plain(*want[0], want[1], level * bits),
                radix.segmented_sort(*want[0], want[1], level * bits))
            errs["radix_sort"] = max(errs["radix_sort"], sort_err)
            if sort_err:
                raise SystemExit(f"segmented sort after level {level} "
                                 f"differs from its plain version on {name}: "
                                 f"{sort_err}")
            emit("kernel", probe=name, mode="radix_partition", level=level,
                 rows=level_in[0].shape[0], live_rows=int(got[1][-1]),
                 segmented_sort_equal=True, equal=True)
            level_in, ends = got
        want = radix.radix_sort3_plain(*planes)
        for impl in radix.IMPLS:
            runs = [("3-key", False)] + ([("key-only", True)] if ordered
                                         else [])
            for what, packed_ordered in runs:
                err = max_err(want, radix.radix_sort3(
                    *planes, impl=impl, packed_ordered=packed_ordered))
                errs["radix_partition"] = max(errs["radix_partition"], err)
                if err:
                    raise SystemExit(f"radix {impl} ({what}) differs from the "
                                     f"3-key sort on {name}: {err}")
                emit("kernel", probe=name, mode="radix_partition", impl=impl,
                     sort=what, rows=planes[0].shape[0], equal=True)
    # The digit widths a geometry picks (``Geometry.radix_bits``), on the
    # two stream probes: each level, the segmented sort after it, and the
    # whole seam of both impls.
    for width in (1, 2, 4, 5):
        for name in ("k1a_stream_32MB", "one_word_stream_32MB"):
            planes = radix_probes[name][0]
            level_in, ends = planes, None
            for level in (1, 2):
                shift = 32 - level * width
                want = radix.partition_level_plain(*level_in, shift, width,
                                                   ends)
                got = radix.partition_level(*level_in, shift, width, ends)
                err = max_err((want[1], *want[0]), (got[1], *got[0]))
                errs["radix_partition"] = max(errs["radix_partition"], err)
                sort_err = max_err(
                    radix.segmented_sort_plain(*want[0], want[1],
                                               level * width),
                    radix.segmented_sort(*want[0], want[1], level * width))
                errs["radix_sort"] = max(errs["radix_sort"], sort_err)
                if err or sort_err:
                    raise SystemExit(f"radix at {width} bits, level {level}, "
                                     f"differs from its plain versions on "
                                     f"{name}: {err}, {sort_err}")
                level_in, ends = got
            want = radix.radix_sort3_plain(*planes)
            for impl in radix.IMPLS:
                err = max_err(want, radix.radix_sort3(
                    *planes, impl=impl, bits=width, packed_ordered=True))
                errs["radix_partition"] = max(errs["radix_partition"], err)
                if err:
                    raise SystemExit(f"radix {impl} at {width} bits differs "
                                     f"from the 3-key sort on {name}: {err}")
            emit("kernel", probe=name, mode="radix_partition", bits=width,
                 levels=[1, 2], segmented_sort_equal=True,
                 seam_impls=list(radix.IMPLS), equal=True)

    mark("kernel")

    # 3 - 8. the main paths, with the launch counters read around each
    by_path: dict[str, dict] = {}
    branches: dict[str, dict] = {}

    def drive(path: str, fn, want_words: dict, need: dict, total=None):
        """Run one main path between cleared counters; check it against the
        oracle (``total``: the expected total when it is not the words'
        sum, as for grams some of which were dropped) and against the
        kernels it must have launched.  Only the combiner paths may take
        the spill fallback, and only they and the n-gram paths (whose map
        is pair mode) may launch pair mode."""
        torch.cuda.synchronize()
        ktok.LAUNCHES.clear()
        radix.LAUNCHES.clear()
        wc.BRANCHES.clear()
        t_a = time.perf_counter()
        got = fn()
        seconds = time.perf_counter() - t_a
        by_path[path] = {**ktok.LAUNCHES, **radix.LAUNCHES}
        branches[path] = dict(wc.BRANCHES)
        if got.as_dict() != want_words or list(got.words) != list(want_words) \
                or got.total != (sum(want_words.values()) if total is None
                                 else total):
            raise SystemExit(f"{path} differs from the oracle")
        for kernel, count in need.items():
            n = by_path[path].get(kernel, 0)
            if not n or (count is not None and n != count):
                raise SystemExit(f"{path} launched {kernel} {n} times")
        if "tokenize_combiner" not in need and (
                (by_path[path].get("tokenize_pair")
                 and "tokenize_pair" not in need)
                or branches[path].get("spill_fallbacks")):
            raise SystemExit(f"{path} took a spill fallback")
        return got, seconds

    words_data = make_corpus(32 * MB, SEED + 2, dense_at=7 * MB)
    want = word_counts(words_data)
    got, words_s = drive("count_words", lambda: count_words(words_data, cfg),
                         want, {"tokenize_compact": 1})
    emit("words", bytes=len(words_data), tokens=got.total,
         distinct=got.distinct, dropped_count=got.dropped_count,
         seconds=round(words_s, 4), launches=by_path["count_words"],
         branches=branches["count_words"], equal_to_oracle=True)
    mark("words")

    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as tmp:
        path = Path(tmp) / "corpus.txt"
        stream_data = make_corpus(130 * MB, SEED + 3, dense_at=70 * MB)
        path.write_bytes(stream_data)
        want_stream = word_counts(stream_data)
        got, stream_s = drive("count_file",
                              lambda: count_file(str(path), cfg),
                              want_stream, {"tokenize_compact": -(
                                  -len(stream_data) // cfg.chunk_bytes)})
        emit("stream", bytes=len(stream_data),
             chunks=-(-len(stream_data) // cfg.chunk_bytes), tokens=got.total,
             distinct=got.distinct, seconds=round(stream_s, 4),
             gb_per_s=round(len(stream_data) / stream_s / 1e9, 4),
             launches=by_path["count_file"], branches=branches["count_file"],
             equal_to_oracle=True)
        mark("stream")

        fused_cfg = Config(map_impl="fused")
        comb_cfg = Config(map_impl="fused", combiner="hot-cache")
        comb_words = with_pairs(words_data, 7 * MB)
        comb_file_data = with_pairs(stream_data[:66 * MB], 40 * MB)
        comb_path = Path(tmp) / "combiner.txt"
        comb_path.write_bytes(comb_file_data)
        comb_need = {"tokenize_combiner": None, "tokenize_pair": None}
        runs = [
            ("count_words_fused", lambda: count_words(words_data, fused_cfg),
             want, {"tokenize_fused": 1}, len(words_data)),
            ("count_words_combiner",
             lambda: count_words(comb_words, comb_cfg),
             word_counts(comb_words), comb_need, len(comb_words)),
            ("count_file_combiner",
             lambda: count_file(str(comb_path), comb_cfg),
             word_counts(comb_file_data), comb_need,
             len(comb_file_data)),
            ("count_words_radix_partition",
             lambda: count_words(words_data,
                                 Config(sort_impl="radix_partition")),
             want, {"tokenize_compact": 1, "radix_partition": 1,
                    "radix_sort": 1}, len(words_data)),
            ("count_words_radix",
             lambda: count_words(words_data, Config(sort_impl="radix")),
             want, {"tokenize_compact": 1, "radix_partition": 2,
                    "radix_sort": 1}, len(words_data)),
        ]
        for name, fn, want_words, need, n_bytes in runs:
            got, seconds = drive(name, fn, want_words, need)
            emit("paths", path=name, bytes=n_bytes, tokens=got.total,
                 distinct=got.distinct, seconds=round(seconds, 4),
                 launches=by_path[name], branches=branches[name],
                 equal_to_oracle=True)
        del comb_words, comb_file_data
        mark("paths")

        # 6. the pipelined executor over ~1 GB
        stream_pipeline(drive, Path(tmp), path, stream_data, want_stream,
                        chunk32, dev)
        mark("stream_pipeline")
        # 7. its failure policy, fault plans and preemption
        faults_phase(drive, Path(tmp), path, stream_data, want_stream)
        mark("faults")
        # 8. its run ledger, registry, flight recorder and profiler
        telemetry_phase(drive, by_path, branches, Path(tmp), path,
                        stream_data, want_stream)
        mark("telemetry")
        # 9. the n-gram and sketched word-count families
        ngram2_want = families_phase(drive, by_path, Path(tmp), path,
                                     stream_data, words_data, dev)
        mark("families")
        # 10. grep and the reservoir sample
        grep_sample_phase(by_path, Path(tmp), path, stream_data,
                          words_data, dev)
        mark("grep_sample")
        # 11. the streamed run over several ranks
        one_rank, ref8 = many_ranks_phase(by_path, Path(tmp), path,
                                          stream_data, want_stream,
                                          ngram2_want, dev)
        mark("many_ranks")
        # 12. the streamed run over several hosts
        many_hosts_phase(by_path, Path(tmp), path, stream_data, want_stream,
                         ngram2_want, one_rank, ref8)
        mark("many_hosts")
        # 13. the map's remaining knobs
        knobs_phase(drive, Path(tmp), path, stream_data, want_stream,
                    words_data, want, one_word32, dev)
        mark("knobs")
        del stream_data, want_stream, one_rank

    # 14. times at the main path's shape: one 32 MB chunk
    t = on_card(chunk32)
    n = t.shape[0]
    kernels = []

    def first_path(kernel: str) -> int:
        return next((v[kernel] for v in by_path.values() if v.get(kernel)), 0)

    def row(name, source, replaces, ms, plain_ms, bytes_moved,
            library_ms=None, **extra):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mapreduce_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": first_path(name),
            "launches_by_path": {k: v.get(name, 0)
                                 for k, v in by_path.items()},
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": library_ms})
        emit("times", kernel=name, chunk_bytes=n, ms=ms, plain_ms=plain_ms,
             bound_ms=kernels[-1]["bound_ms"], bytes_moved=bytes_moved,
             library_ms=library_ms, **extra)

    # The three tokenize modes are one kernel; each row times its wrapper
    # (the zeroed work buffer and the launch).  Bound: the chunk read once,
    # live + 1 rows of 24 B and the four counters written.
    dense_rows = k1a.packed.shape[0]  # live + 1
    # The TPU-shaped layout's rows for the same chunk (1,024 per 3,072-byte
    # window, dead filler included), for comparison with dense_rows.
    windowed_rows = -(-n // 3072) * 1024
    one_word_chunk = on_card(one_word32)
    tok_plain_ms = cuda_ms(lambda: ktok.tokenize_stream_plain(t, w), iters=5)
    sites = {"tokenize_compact": "mapreduce_tpu/ops/pallas/tokenize.py:231",
             "tokenize_pair": "mapreduce_tpu/ops/pallas/tokenize.py:231",
             "tokenize_fused": "mapreduce_tpu/ops/pallas/tokenize.py:871"}
    for mode, wrapper in modes.items():
        row(mode, "tokenize.cu", sites[mode],
            cuda_ms(lambda: wrapper(t, w)), tok_plain_ms,
            n + 24 * dense_rows + 4 * 8, live_rows=dense_rows - 1,
            rows=dense_rows, windowed_rows=windowed_rows,
            tiles=-(-n // ktok.TILE),
            one_word_ms=cuda_ms(lambda: wrapper(one_word_chunk, w)))
    comb_rows = comb_counts["zipf_32MB"]["stream_rows"]
    row("tokenize_combiner", "tokenize.cu",
        "mapreduce_tpu/ops/pallas/tokenize.py:388",
        cuda_ms(lambda: ktok.tokenize_combiner_kernel(
            t, w, ktok.COMBINER_SLOTS, cslots)),
        cuda_ms(lambda: ktok.tokenize_combiner_plain(
            t, w, ktok.COMBINER_SLOTS, cslots), iters=5),
        n + 3 * 8 * comb_rows + 4 * 8 * cslots * ktok.SEGMENTS + 3 * 8,
        stream_rows=comb_rows, dense_rows=dense_rows,
        hits=comb_counts["zipf_32MB"]["hits"],
        flush_rows=comb_counts["zipf_32MB"]["flush_rows"],
        windows=ktok.SEGMENTS * ktok._combiner_geometry(n)[1],
        phase_ms=staged_ms(lambda timer: ktok.tokenize_combiner_kernel(
            t, w, ktok.COMBINER_SLOTS, cslots, timer=timer)),
        one_word_ms=cuda_ms(lambda: ktok.tokenize_combiner_kernel(
            one_word_chunk, w, ktok.COMBINER_SLOTS, cslots)))
    # K2 on the dense stream of the chunk: the seam (radix_sort3, 3-key)
    # against its plain version, the 3-key sort; yardsticks the port's own
    # 3-key sort call (table._lexsort, the sort3 build's) and the default
    # build's stable argsort of the sign-flipped key with its gathers.
    n_rows = rows[0].shape[0]
    n_live = int(live.sum())
    hbm_ms = 1e3 / HBM_BYTES_PER_S

    def default_sort():
        k = table_ops._key64(rows[0], rows[1])
        order = torch.argsort(k, stable=True)
        return k[order], rows[2][order]

    seam_stages = {
        impl: staged_ms(lambda timer, impl=impl: radix.radix_sort3_kernel(
            *rows, impl, radix.DEFAULT_BITS, packed_ordered=True,
            timer=timer))
        for impl in radix.IMPLS}
    row("radix_partition", "radix.cu",
        "mapreduce_tpu/ops/pallas/radix.py:104",
        cuda_ms(lambda: radix.radix_sort3(*rows, impl="radix_partition")),
        cuda_ms(lambda: radix.radix_sort3_plain(*rows), iters=5),
        2 * 3 * 8 * n_rows,  # read three planes, write them sorted
        library_ms=cuda_ms(lambda: table_ops._lexsort(
            table_ops._key64(rows[0], rows[1]), rows[2])),
        rows=n_rows, live_rows=n_live,
        stable2_seam_ms=cuda_ms(lambda: radix.radix_sort3(
            *rows, impl="radix_partition", packed_ordered=True)),
        radix_ms=cuda_ms(lambda: radix.radix_sort3(*rows, impl="radix")),
        radix_stable2_ms=cuda_ms(lambda: radix.radix_sort3(
            *rows, impl="radix", packed_ordered=True)),
        argsort_ms=cuda_ms(default_sort),
        level_ms=cuda_ms(lambda: radix.partition_level(
            *rows, 32 - radix.DEFAULT_BITS, radix.DEFAULT_BITS)),
        level_bound_ms=2 * 3 * 8 * n_rows * hbm_ms,
        stage_ms=seam_stages,
        # a seam level reads 24 B a row and writes 12 B a live row; a sort
        # pass reads and writes 12 B a live row (the last writes int64
        # planes of every row)
        stage_bound_ms={"level_1": (24 * n_rows + 12 * n_live) * hbm_ms,
                        "level_2": 24 * n_live * hbm_ms,
                        "sort_pass": 24 * n_live * hbm_ms,
                        "last_pass": (12 * n_live + 24 * n_rows) * hbm_ms})
    lvl, lvl_ends = radix.partition_level(*rows, 32 - radix.DEFAULT_BITS,
                                          radix.DEFAULT_BITS)
    # The library call for the segmented sort: one stable lexsort with the
    # group index as the most significant key (within a group the
    # partition's digit is equal, so the whole key orders the same), the
    # dead rows past the last end a group of their own.
    group = torch.searchsorted(
        lvl_ends.to(torch.int64),
        torch.arange(n_rows, dtype=torch.int64, device=dev), right=True)
    row("radix_sort", "radix.cu", "mapreduce_tpu/ops/pallas/radix.py:306",
        cuda_ms(lambda: radix.segmented_sort(*lvl, lvl_ends,
                                             radix.DEFAULT_BITS)),
        cuda_ms(lambda: radix.segmented_sort_plain(*lvl, lvl_ends,
                                                   radix.DEFAULT_BITS),
                iters=5),
        3 * 8 * n_live + 3 * 8 * n_rows,  # read the live rows, write all
        library_ms=cuda_ms(lambda: table_ops._lexsort(
            group, table_ops._key64(lvl[0], lvl[1]), lvl[2])),
        rows=n_rows, live_rows=n_live, passes=len(radix.sort_passes(
            radix.DEFAULT_BITS, with_packed=True)))
    del group
    del lvl

    # The chunk's end-to-end time, by stage (each stage synchronised).
    stage = {"tokenize": [], "aggregate": [], "merge": [], "step": []}
    running = table_ops.empty(cfg.table_capacity, dev)
    host = np.frombuffer(chunk32, np.uint8)
    for _ in range(6):
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        chunk = torch.from_numpy(host.copy()).to(dev)
        stream, overlong, spill = ktok.tokenize_split_compact(chunk, w)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        upd = wc._map_stream(chunk, cfg, cfg.batch_uniques, pos_hi=0)
        torch.cuda.synchronize()
        t_c = time.perf_counter()
        running = table_ops.merge(running, upd, capacity=cfg.table_capacity)
        torch.cuda.synchronize()
        t_d = time.perf_counter()
        stage["tokenize"].append((t_b - t_a) * 1e3)
        stage["aggregate"].append((t_c - t_b) * 1e3)  # map incl. tokenize
        stage["merge"].append((t_d - t_c) * 1e3)
        stage["step"].append((t_d - t_b) * 1e3)
    med = {k: statistics.median(v[1:]) for k, v in stage.items()}
    emit("times", chunk_bytes=n, h2d_plus_tokenize_ms=med["tokenize"],
         map_ms=med["aggregate"], merge_ms=med["merge"],
         step_ms=med["step"], step_gb_per_s=n / med["step"] / 1e6,
         overlong=int(overlong), spill=int(spill))

    # The step (map + merge) of each path's configuration on the same
    # device-resident chunk, in turns so drift spreads over all of them.
    step_cfgs = {"default": cfg, "fused": fused_cfg, "combiner": comb_cfg,
                 "radix_partition": Config(sort_impl="radix_partition"),
                 "radix": Config(sort_impl="radix")}
    steps = {k: [] for k in step_cfgs}
    chunk = torch.from_numpy(host.copy()).to(dev)
    # The rows each configuration's aggregation sort sees on this chunk:
    # from_packed_rows records its input in one untimed step each.
    sort_rows: dict = {}
    build = table_ops.from_packed_rows
    for name, c in step_cfgs.items():
        def record(key_hi, *args, _name=name, **kw):
            sort_rows.setdefault(_name, []).append(key_hi.shape[0])
            return build(key_hi, *args, **kw)
        table_ops.from_packed_rows = record
        try:
            wc._map_stream(chunk, c, c.batch_uniques, pos_hi=0)
        finally:
            table_ops.from_packed_rows = build
    for rep in range(16):
        for name, c in step_cfgs.items():
            torch.cuda.synchronize()
            wc.BRANCHES.clear()
            t_a = time.perf_counter()
            upd = wc._map_stream(chunk, c, c.batch_uniques, pos_hi=0)
            run = table_ops.merge(running, upd, capacity=c.table_capacity)
            torch.cuda.synchronize()
            if rep:
                steps[name].append((time.perf_counter() - t_a) * 1e3)
            if name == "combiner":
                comb_branches = dict(wc.BRANCHES)
    emit("times", chunk_bytes=n,
         step_ms={k: statistics.median(v) for k, v in steps.items()},
         step_ms_all={k: [round(x, 3) for x in v] for k, v in steps.items()},
         sort_rows=sort_rows, windowed_rows=windowed_rows,
         combiner_per_chunk={
             "hits": comb_branches.get("combiner_hits", 0),
             "flush_rows": comb_branches.get("combiner_flushes", 0),
             "stream_rows": comb_rows, "dense_stream_rows": dense_rows,
             "spill_fallbacks": comb_branches.get("spill_fallbacks", 0)})

    mark("times")

    # 15. Where a step's device time goes, for the default, combiner and
    # both radix configurations: torch.profiler over 3 steps, device kernels
    # only (the aten ops that launch them would count twice).  The busy
    # share divides it by the unprofiled step time measured above.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step_med = {k: statistics.median(v) for k, v in steps.items()}
    for name in ("default", "combiner", "radix_partition", "radix"):
        c = step_cfgs[name]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_a = time.perf_counter()
            for _ in range(3):
                upd = wc._map_stream(chunk, c, c.batch_uniques, pos_hi=0)
                run = table_ops.merge(running, upd,
                                      capacity=c.table_capacity)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t_a) * 1e6
        by_kernel = sorted(
            ((e.key, e.self_device_time_total / 3e3, e.count // 3)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total),
            key=lambda r: -r[1])
        device_ms = sum(r[1] for r in by_kernel)
        emit("profile", config=name, steps=3, sort_rows=sort_rows[name],
             profiled_wall_ms_per_step=wall_us / 3e3,
             device_ms_per_step=device_ms,
             device_launches_per_step=sum(r[2] for r in by_kernel),
             device_busy_share=device_ms / step_med[name],
             top=[{"op": k[:60], "ms_per_step": round(ms, 4), "calls": n_}
                  for k, ms, n_ in by_kernel[:12]])
    del run
    mark("profile")
    emit("phase_time", name="total",
         seconds=round(time.perf_counter() - t_start, 3))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_name(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    raise SystemExit(main())
