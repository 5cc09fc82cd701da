#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports only the port (``mapreduce_tpu_torch``), never JAX, and exits
non-zero when no card is present.  Phases, each printing one JSON line:

1. build   -- compile ``mapreduce_tpu_torch/csrc/tokenize.cu`` with nvcc;
2. kernel  -- the tokenize kernel's public wrappers (compact and pair mode)
              against its plain PyTorch version on the card: a 32 MB Zipf
              chunk, a dense chunk
              that must spill, overlong runs at window and chunk edges, and
              a chunk of exactly ``pallas_min_chunk`` bytes; exact equality;
3. words   -- ``count_words`` at ``Config()`` defaults (32 MB chunk, table
              capacity 2**18) on a seeded 32 MB corpus, equal to the oracle;
4. stream  -- ``count_file`` over a seeded corpus of at least 128 MB
              (4 chunks or more), equal to the oracle;
5. times   -- the kernel's median time per 32 MB chunk beside its bound,
              its plain version's time, and the chunk's end-to-end time by
              stage.

Phases 3 and 4 each drive a main path (``count_words``, and the streamed
``count_file``): the kernel launch counters are set to 0 just before each
and read just after it, and each must have launched both modes (both
corpora hold a dense region that takes the spill fallback).  The
``launches`` of the kernels line are ``count_words``'s, one 32 MB chunk;
``launches_by_path`` gives both.  Before the last line it prints one
``{"kernels": [...]}`` line and the card's ``nvidia-smi`` name and power
limit; the last line is ``{"ok": true, "device": {...}}``.
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


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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
    letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
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


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "false); this script measures the port on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from mapreduce_tpu_torch import Config, count_file, count_words
    from mapreduce_tpu_torch.models import wordcount as wc
    from mapreduce_tpu_torch.ops import table as table_ops
    from mapreduce_tpu_torch.ops.cuda import _build
    from mapreduce_tpu_torch.ops.cuda import tokenize as ktok
    from mapreduce_tpu_torch.utils import oracle

    dev = torch.device("cuda")
    cfg = Config()
    w = cfg.pallas_max_token
    modes = {"tokenize_compact": ktok.COMPACT_SLOTS,
             "tokenize_pair": ktok.PAIR_SLOTS}

    # 1. build
    t0 = time.perf_counter()
    lib_path, report = _build.build("tokenize")
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         library=str(lib_path.relative_to(ROOT)),
         ptxas=[ln for ln in report.splitlines() if "ptxas" in ln][-3:])

    # 2. the wrappers the main path calls against the plain version
    # (launches here do not count: the counters are cleared after)
    chunk32 = make_corpus(32 * MB, SEED, dense_at=None)
    probes = {
        "zipf_32MB": chunk32,
        "dense_spills": b"a b " * (MB // 4),
        "edges": edge_chunk(4 * MB + 77, w, ktok.WINDOW),
        "min_chunk": make_corpus(cfg.pallas_min_chunk, SEED + 1),
    }
    max_err = {m: 0 for m in modes}
    for name, data in probes.items():
        t = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
        for mode, slots in modes.items():
            want = ktok.tokenize_windows_plain(t, w, slots)
            if mode == "tokenize_compact":
                stream, over, spill = ktok.tokenize_split_compact(t, w)
            else:
                stream, over = ktok.tokenize_split(t, w)
                spill = want[5]  # pair mode returns none: checked below
            got = (stream.key_hi, stream.key_lo, stream.packed, over,
                   stream.total, spill)
            torch.cuda.synchronize()
            errs = [int((a - b).abs().max()) for a, b in zip(want, got)]
            max_err[mode] = max(max_err[mode], *errs)
            if any(errs):
                raise SystemExit(f"kernel {mode} differs from its plain "
                                 f"version on {name}: {errs}")
            over, ntok, spill = (int(x) for x in got[3:])
            emit("kernel", probe=name, mode=mode, bytes=len(data),
                 overlong=over, tokens=ntok, spill=spill, equal=True)
            if name == "dense_spills" and mode == "tokenize_compact" \
                    and not spill:
                raise SystemExit("dense probe did not spill")
            if mode == "tokenize_pair" and spill:
                raise SystemExit("pair mode spilled")

    # 3 + 4. the main paths, with the launch counters read around each
    words_data = make_corpus(32 * MB, SEED + 2, dense_at=7 * MB)
    torch.cuda.synchronize()
    ktok.LAUNCHES.clear()
    wc.BRANCHES.clear()
    t0 = time.perf_counter()
    got = count_words(words_data, cfg)
    words_s = time.perf_counter() - t0
    by_path = {"count_words": dict(ktok.LAUNCHES)}
    want = oracle.word_counts(words_data)
    if got.as_dict() != want or got.total != sum(want.values()) \
            or list(got.words) != list(want):
        raise SystemExit("count_words differs from the oracle")
    emit("words", bytes=len(words_data), tokens=got.total,
         distinct=got.distinct, dropped_count=got.dropped_count,
         seconds=round(words_s, 4), launches=by_path["count_words"],
         branches=dict(wc.BRANCHES), equal_to_oracle=True)

    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as tmp:
        path = Path(tmp) / "corpus.txt"
        stream_data = make_corpus(130 * MB, SEED + 3, dense_at=70 * MB)
        path.write_bytes(stream_data)
        torch.cuda.synchronize()
        ktok.LAUNCHES.clear()
        wc.BRANCHES.clear()
        t0 = time.perf_counter()
        got = count_file(str(path), cfg)
        stream_s = time.perf_counter() - t0
        by_path["count_file"] = dict(ktok.LAUNCHES)
    want = oracle.word_counts(stream_data)
    if got.as_dict() != want or list(got.words) != list(want):
        raise SystemExit("count_file differs from the oracle")
    emit("stream", bytes=len(stream_data),
         chunks=-(-len(stream_data) // cfg.chunk_bytes), tokens=got.total,
         distinct=got.distinct, seconds=round(stream_s, 4),
         gb_per_s=round(len(stream_data) / stream_s / 1e9, 4),
         launches=by_path["count_file"], branches=dict(wc.BRANCHES),
         equal_to_oracle=True)
    for path_name, launches in by_path.items():
        for mode in modes:
            if not launches.get(mode):
                raise SystemExit(f"{path_name} never launched {mode}")

    # 5. times at the main path's shape: one 32 MB chunk
    t = torch.frombuffer(bytearray(chunk32), dtype=torch.uint8).to(dev)
    n = t.shape[0]
    kernels = []
    for mode, slots in modes.items():
        rows = -(-n // ktok.WINDOW) * slots
        bytes_moved = n + 3 * 8 * rows + 3 * 8  # read chunk, write planes
        plain_ms = cuda_ms(lambda: ktok.tokenize_windows_plain(t, w, slots),
                           iters=5)
        ms = cuda_ms(lambda: ktok.tokenize_windows_kernel(t, w, slots))
        kernels.append({
            "name": mode, "route": "cuda",
            "source": "mapreduce_tpu_torch/csrc/tokenize.cu",
            "replaces": "mapreduce_tpu/ops/pallas/tokenize.py:231",
            "launches": by_path["count_words"].get(mode, 0),
            "launches_by_path": {k: v.get(mode, 0)
                                 for k, v in by_path.items()},
            "max_abs_err": max_err[mode], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None})
        emit("times", kernel=mode, chunk_bytes=n, ms=ms, plain_ms=plain_ms,
             bound_ms=kernels[-1]["bound_ms"], bytes_moved=bytes_moved)

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

    # Where a step's device time goes: torch.profiler over 3 steps, device
    # kernels only (the aten ops that launch them would count twice).  The
    # busy share divides it by the unprofiled step time measured above.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    chunk = torch.from_numpy(host.copy()).to(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_a = time.perf_counter()
        for _ in range(3):
            upd = wc._map_stream(chunk, cfg, cfg.batch_uniques, pos_hi=0)
            running = table_ops.merge(running, upd,
                                      capacity=cfg.table_capacity)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t_a) * 1e6
    by_kernel = sorted(
        ((e.key, e.self_device_time_total / 3e3, e.count // 3)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total),
        key=lambda r: -r[1])
    device_us = sum(r[1] for r in by_kernel) * 3e3
    emit("profile", steps=3, profiled_wall_ms_per_step=wall_us / 3e3,
         device_ms_per_step=device_us / 3e3,
         device_busy_share=device_us / 3e3 / med["step"],
         top=[{"op": k[:60], "ms_per_step": round(ms, 4), "calls": c}
              for k, ms, c in by_kernel[:12]])

    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    raise SystemExit(main())
