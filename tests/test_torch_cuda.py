"""The port on the card: the CUDA kernels against their plain versions.

Every test here needs an NVIDIA card and carries the ``cuda`` marker; where
``torch.cuda.is_available()`` is false each one skips with the reason.  The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest sets up JAX.)  Comparisons are
exact, tolerance zero: the kernel hashes and counts integers.
"""

import functools
import pathlib
import time

import numpy as np
import pytest
import torch

from mapreduce_tpu_torch.data import reader as reader_mod
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.ops.cuda import radix
from mapreduce_tpu_torch.ops.cuda import tokenize as ktok
from mapreduce_tpu_torch.runtime import executor
from mapreduce_tpu_torch.utils import oracle

REPO = pathlib.Path(__file__).resolve().parents[1]
W = 32  # the default lookback


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _zipf_text(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    words = [b"w%x" % i for i in range(3000)] + [b"u" * 40, b"v" * 70]
    seps = [b" ", b"\n", b"\t", b"  ", b" \r\n"]
    ids = rng.zipf(1.2, n // 3) % len(words)
    sep_ids = rng.integers(0, len(seps), ids.shape[0])
    text = b"".join(words[i] + seps[s] for i, s in zip(ids, sep_ids))
    return text[:n]


def _edges(n: int, every: int = ktok.WINDOW) -> bytes:
    """Runs of W-1, W, W+1 and 3W bytes against every window edge (or
    every ``every`` bytes) and at both ends of the chunk."""
    buf = bytearray((b"ab cd " * (n // 6 + 1))[:n])
    runs = [W - 1, W, W + 1, 3 * W]
    for i, edge in enumerate(range(every, n - 4 * W, every)):
        run = runs[i % 4]
        # Last byte before the edge, last byte at it, first byte at it,
        # across it.
        start = edge - (run, run - 1, 0, run // 2)[(i // 4) % 4]
        buf[start - 1] = 0x20
        buf[start:start + run] = b"x" * run
        buf[start + run] = 0x20
    buf[:3 * W + 1] = b"s" * (3 * W) + b" "
    buf[n - 3 * W - 1:] = b" " + b"e" * (3 * W)
    return bytes(buf)


CASES = {
    "zipf": lambda: _zipf_text(0, 1 << 20),
    "edges": lambda: _edges((1 << 18) + 77),
    "tile_edges": lambda: _edges((1 << 19) + 5, ktok.TILE),
    "dense": lambda: b"a b " * (1 << 16),
    "tiny": lambda: b"hello",
    # One word over 1,024 tiles of equal counts: long look-back chains.
    "one_word": lambda: b"the " * (1 << 20),
    "separators": lambda: b" \n" * (1 << 17),  # live = 0: the dead row only
    "max_chunk": lambda: _zipf_text(3, 1 << 22) * 16,  # 2**26 bytes
}


@functools.lru_cache(maxsize=None)
def _case_bytes(case: str) -> bytes:
    return CASES[case]()


def _stream_fields(stream, over, spill):
    """A stream cut to its rows, as the tensors a comparison reads."""
    cut = stream.cut()
    return (cut.key_hi, cut.key_lo, cut.packed, cut.total, stream.live, over,
            spill)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("w", [1, W, 63])
def test_kernel_matches_plain_version(cuda_device, case, w):
    """The planes up to ``live + 1`` and the counters, exactly; the planes
    are sized for the densest stream."""
    data = _dev_bytes(_case_bytes(case), cuda_device)
    want = ktok.tokenize_stream_plain(data, w)
    got = ktok.tokenize_stream_kernel(data, w)
    torch.cuda.synchronize()
    assert got[0].key_hi.shape[0] == -(-data.shape[0] // 2) + 1
    for a, b in zip(_stream_fields(*want), _stream_fields(*got)):
        assert torch.equal(a.cpu(), b.cpu())
    assert int(got[2]) == 0  # no spill
    if case == "separators":
        assert int(got[0].live) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 7, 15])
def test_kernel_on_a_misaligned_view(cuda_device, offset):
    """A view that starts off a 16-byte boundary moves the tile edges."""
    data = _dev_bytes(_zipf_text(4, 1 << 18), cuda_device)[offset:]
    assert data.data_ptr() % 16 == offset
    want = ktok.tokenize_stream_plain(data, W)
    got = ktok.tokenize_stream_kernel(data, W)
    for a, b in zip(_stream_fields(*want), _stream_fields(*got)):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_stream_wrappers_read_nothing_back(cuda_device):
    """The wrappers leave the live count on the card: the caller cuts."""
    data = _dev_bytes(_zipf_text(0, 1 << 20), cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stream, over, spill = ktok.tokenize_split_compact(data, W)
        ktok.tokenize_split(data, W)
        ktok.tokenize_fused(data, max_token_bytes=W)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(stream.live) == int(stream.total) + int(over)


@pytest.mark.cuda
def test_wrappers_count_launches_and_check_input(cuda_device):
    data = _dev_bytes(CASES["zipf"](), cuda_device)
    before = dict(ktok.LAUNCHES)
    ktok.tokenize_split_compact(data, W)
    ktok.tokenize_split(data, W)
    assert ktok.LAUNCHES["tokenize_compact"] == \
        before.get("tokenize_compact", 0) + 1
    assert ktok.LAUNCHES["tokenize_pair"] == before.get("tokenize_pair", 0) + 1
    with pytest.raises(TypeError):
        ktok.tokenize_split(data.to(torch.int32), W)


@pytest.mark.cuda
def test_count_words_and_count_file_on_the_card(cuda_device, tmp_path):
    data = (REPO / "test.txt").read_bytes()
    got = wc.count_words(data)
    assert got.as_dict() == oracle.word_counts(data)
    assert got.total == 9
    corpus = _zipf_text(1, 1 << 16)
    path = tmp_path / "corpus.txt"
    path.write_bytes(corpus)
    got = executor.count_file(str(path), wc.Config(chunk_bytes=1 << 14))
    assert got.as_dict() == oracle.word_counts(corpus)
    assert list(got.words) == list(oracle.word_counts(corpus))


@pytest.mark.cuda
@pytest.mark.parametrize("data", [
    b" \n\t" * 4000,  # separators only: the stream is its dead row
    b"a b c d " * 5000,  # the densest text: no fallback
    b"ab " * 4000 + b" ".join([b"x" * 40, b"y" * 90, b"z" * 33]),  # poisons last
])
def test_count_words_on_edge_buffers_on_the_card(cuda_device, data):
    wc.BRANCHES.clear()
    got = wc.count_words(data)
    assert got.as_dict() == oracle.word_counts(data)
    assert got.total == oracle.total_count(data)
    assert got.dropped_count == 0
    assert not wc.BRANCHES["spill_fallbacks"]


# Segments of two combiner windows: every segment edge is a window edge,
# and _edges puts runs across each of them.
N_SEG = ktok.SEGMENTS * 2 * ktok.WINDOW
LETTERS = b"abcdefghijklmnopqrstuvwxyz"

COMBINER_CASES = {
    "zipf": lambda: _zipf_text(0, 1 << 20),
    "edges": lambda: _edges(N_SEG),
    "dense": lambda: b"a b " * (1 << 16),  # two keys: all cached
    # 676 two-letter keys, 1,024 a window: the thinned windows spill
    "dense_pairs": lambda: (b" ".join(bytes([a, b]) for a in LETTERS
                                      for b in LETTERS) * 400)[:N_SEG],
    "single": lambda: b"hot " * (N_SEG // 4),
}


def _dev_bytes(data: bytes, device) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(COMBINER_CASES))
@pytest.mark.parametrize("cslots", [8, 32])
def test_combiner_kernel_matches_plain_version(cuda_device, case, cslots):
    data = _dev_bytes(COMBINER_CASES[case](), cuda_device)
    want = ktok.tokenize_combiner_plain(data, W, ktok.COMBINER_SLOTS, cslots)
    got = ktok.tokenize_combiner_kernel(data, W, ktok.COMBINER_SLOTS, cslots)
    torch.cuda.synchronize()
    # The dense thinned stream up to its dead row, and the counters.
    for a, b in zip(_stream_fields(*want[:3]), _stream_fields(*got[:3])):
        assert torch.equal(a.cpu(), b.cpu())
    for a, b in zip(want[3], got[3]):
        assert torch.equal(a.cpu(), b.cpu())
    spill = int(got[2])
    assert (spill > 0) == (case == "dense_pairs"), spill
    if case == "single":
        assert int(got[0].total) == 0  # every occurrence cached


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zipf", "edges", "dense"])
def test_fused_mode_is_the_compact_stream(cuda_device, case):
    data = _dev_bytes(CASES[case](), cuda_device)
    before = ktok.LAUNCHES["tokenize_fused"]
    fused = ktok.tokenize_fused(data, max_token_bytes=W)
    compact = ktok.tokenize_split_compact(data, W)
    torch.cuda.synchronize()
    assert ktok.LAUNCHES["tokenize_fused"] == before + 1
    for a, b in zip(_stream_fields(*fused), _stream_fields(*compact)):
        assert torch.equal(a.cpu(), b.cpu())


def _radix_probes(device):
    """The dense stream of a Zipf MB, the same rows in one top-level
    bucket, random triples with ``key_hi >= 2**31``, a hot key holding over
    half the live rows, one key in every live row (every pass sees one
    digit), a stream of poison rows ``(sent, sent-1)`` in shuffled
    ``packed`` order, and an all-dead stream."""
    stream = ktok.tokenize_split_compact(
        _dev_bytes(_zipf_text(0, 1 << 20), device), W)[0].cut()
    rows = (stream.key_hi, stream.key_lo, stream.packed)
    live = ~((rows[0] == ktok._SENT) & (rows[1] == ktok._SENT))
    one_key = torch.where(live, 0x8765_4321, rows[0])
    g = torch.Generator().manual_seed(5)
    n = 200_000
    high = (torch.randint(1 << 31, (1 << 32) - 1, (n,), generator=g),
            torch.randint(0, 1 << 32, (n,), generator=g),
            torch.randperm(n, generator=g) << 6 | 3)
    hot = torch.rand(rows[0].shape[0], generator=g).to(device) < 0.6
    poison = (torch.full((n,), ktok._SENT, dtype=torch.int64),
              torch.full((n,), ktok._SENT - 1, dtype=torch.int64),
              torch.randperm(n, generator=g) << 6)
    dead = torch.full((5000,), ktok._SENT, dtype=torch.int64)
    return {"stream": rows, "one_bucket": (one_key, *rows[1:]),
            "high_keys": tuple(x.to(device) for x in high),
            "hot_key": (torch.where(live & hot, 0x9000_0001, rows[0]),
                        torch.where(live & hot, 0x1234_5678, rows[1]),
                        rows[2]),
            "single_key": (torch.where(live, 0xF000_0000, rows[0]),
                           torch.where(live, 7, rows[1]), rows[2]),
            "poison": tuple(x.to(device) for x in poison),
            "all_dead": tuple(dead.clone().to(device) for _ in range(3))}


def _equal(want, got, what):
    for a, b in zip(want, got):
        assert torch.equal(a.cpu(), b.cpu()), what


@pytest.mark.cuda
@pytest.mark.parametrize("impl", radix.IMPLS)
@pytest.mark.parametrize("bits", [1, 3, 5])
def test_radix_kernel_matches_plain_version(cuda_device, impl, bits):
    for name, planes in _radix_probes(cuda_device).items():
        want = radix.radix_sort3_plain(*planes)
        before = dict(radix.LAUNCHES)
        got = radix.radix_sort3(*planes, impl=impl, bits=bits)
        torch.cuda.synchronize()
        _equal(want, got, (name, impl, bits))
        levels = radix.LAUNCHES["radix_partition"] \
            - before.get("radix_partition", 0)
        assert levels == (2 if impl == "radix" else 1)
        assert radix.LAUNCHES["radix_sort"] == before.get("radix_sort", 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 3, 5])
def test_radix_partition_level_matches_plain_partition(cuda_device, bits):
    """Each level on its own, row for row (both are stable), with the same
    bucket ends and the dead fill; the second level reads the first
    level's kernel output and ends."""
    for name, planes in _radix_probes(cuda_device).items():
        ends = None
        for level in (1, 2):
            shift = 32 - level * bits
            want = radix.partition_level_plain(*planes, shift, bits, ends)
            got = radix.partition_level(*planes, shift, bits, ends)
            _equal((want[1], *want[0]), (got[1], *got[0]), (name, level))
            planes, ends = got


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 3, 5])
@pytest.mark.parametrize("with_packed", [True, False])
def test_segmented_sort_kernel_matches_plain_version(cuda_device, bits,
                                                     with_packed):
    """The segmented sort on its own, on the plain partitions of every
    probe: one level (the top ``bits`` decided) and two."""
    for name, planes in _radix_probes(cuda_device).items():
        ends = None
        for level in (1, 2):
            planes, ends = radix.partition_level_plain(
                *planes, 32 - level * bits, bits, ends)
            want = radix.segmented_sort_plain(*planes, ends, level * bits,
                                              with_packed)
            got = radix.segmented_sort(*planes, ends, level * bits,
                                       with_packed)
            torch.cuda.synchronize()
            _equal(want, got, (name, level))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", radix.IMPLS)
def test_radix_seam_reads_nothing_back(cuda_device, impl):
    """The seam on a CUDA tensor never synchronises with the host: no
    read-back of the live count, no torch sort or ``cat``."""
    planes = _radix_probes(cuda_device)["stream"]
    want = radix.radix_sort3_plain(*planes)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = radix.radix_sort3(*planes, impl=impl)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _equal(want, got, impl)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(COMBINER_CASES))
@pytest.mark.parametrize("cslots", [8, 32])
def test_combiner_phases_match_plain_versions(cuda_device, case, cslots):
    """The combiner's phases, now one launch (each window's rows, its
    segment's key list, the thinned rows), run four times against the
    plain version on the same input (the windows start in a different
    order each time), and the fold of its flushed cache into a table of
    the thinned stream."""
    data = _dev_bytes(COMBINER_CASES[case](), cuda_device)
    w, slots = W, ktok.COMBINER_SLOTS
    want = ktok.tokenize_combiner_plain(data, w, slots, cslots)
    for _ in range(4):
        got = ktok.tokenize_combiner_kernel(data, w, slots, cslots)
        _equal((*_stream_fields(*want[:3]), *want[3]),
               (*_stream_fields(*got[:3]), *got[3]), "combiner_stream")
    t = wc.table_ops.from_stream(got[0].cut(), 4096, pos_hi=3,
                                 max_token_bytes=w, max_pos=data.shape[0],
                                 sort_mode="stable2")
    _equal(ktok.combiner_fold_plain(t, got[3], 3),
           ktok.combiner_fold_kernel(t, got[3], 3), "fold")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    {"map_impl": "fused", "combiner": "hot-cache"},
    {"map_impl": "fused", "combiner": "hot-cache", "combiner_slots": 32},
    {"sort_impl": "radix_partition"},
    {"sort_impl": "radix", "sort_mode": "sort3"},
])
def test_new_paths_on_the_card(cuda_device, kw):
    corpus = _zipf_text(2, 1 << 20) + b" " + b" ".join(
        bytes([c]) for c in LETTERS * 3000)
    cfg = wc.Config(chunk_bytes=1 << 19, **kw)
    got = wc.count_words(corpus, cfg)
    assert got.as_dict() == oracle.word_counts(corpus)
    assert list(got.words) == list(oracle.word_counts(corpus))


def _stream_files(tmp_path, n_files: int = 3, n_bytes: int = 1 << 20):
    paths, joined = [], []
    for i in range(n_files):
        data = _zipf_text(20 + i, n_bytes)
        (tmp_path / f"part{i}.txt").write_bytes(data)
        paths.append(str(tmp_path / f"part{i}.txt"))
        joined.append(data)
    return paths, b"\n".join(joined)


@pytest.mark.cuda
def test_stream_pipeline_many_small_groups(cuda_device, tmp_path):
    """A fast reader and many small groups (16 KB chunks, window 4,
    prefetch 16, a superstep of 3) against the serial control and the
    oracle: a pinned buffer refilled before its copy read it would show
    as a wrong count here."""
    paths, joined = _stream_files(tmp_path)
    fast = wc.Config(chunk_bytes=1 << 14, inflight_groups=4,
                     prefetch_depth=16, superstep=3)
    serial = wc.Config(chunk_bytes=1 << 14, inflight_groups=1,
                       prefetch_depth=1)
    got = executor.count_file(paths, fast)
    want = executor.count_file(paths, serial)
    assert got.as_dict() == want.as_dict() == oracle.word_counts(joined)
    assert list(got.words) == list(want.words)
    assert got.total == want.total
    pipe = got.run.pipeline
    assert pipe["depth_max"] == 4 and pipe["pinned_buffers"] <= 16 + 2
    assert pipe["h2d_ms_per_chunk"] > 0


@pytest.mark.cuda
def test_h2d_copies_run_on_the_copy_stream(cuda_device, tmp_path,
                                           monkeypatch):
    """Every H2D chunk copy is issued on a stream other than the compute
    stream, and the compute stream waits on each copy's event."""
    paths, _ = _stream_files(tmp_path, n_files=1)
    compute = torch.cuda.current_stream()
    copies, recorded, waited = [], [], []
    real_copy = torch.Tensor.copy_
    real_record = torch.cuda.Event.record
    real_wait = torch.cuda.Stream.wait_event

    def copy_(self, src, non_blocking=False):
        if self.is_cuda and not src.is_cuda:
            copies.append((torch.cuda.current_stream(), non_blocking,
                           src.is_pinned()))
        return real_copy(self, src, non_blocking=non_blocking)

    def record(self, stream=None):
        recorded.append((self, stream or torch.cuda.current_stream()))
        return real_record(self, stream)

    def wait_event(self, event):
        waited.append((self, event))
        return real_wait(self, event)

    monkeypatch.setattr(torch.Tensor, "copy_", copy_)
    monkeypatch.setattr(torch.cuda.Event, "record", record)
    monkeypatch.setattr(torch.cuda.Stream, "wait_event", wait_event)
    cfg = wc.Config(chunk_bytes=1 << 16)
    got = executor.count_file(paths, cfg)
    n_chunks = got.run.bases.shape[0]
    assert len(copies) == n_chunks > 8
    assert all(s != compute and nb and pinned for s, nb, pinned in copies)
    on_copy = [ev for ev, s in recorded if s != compute]
    assert len(on_copy) == 2 * n_chunks  # the timing start and the copy
    assert len(waited) == n_chunks
    assert all(s == compute for s, _ in waited)
    assert all(any(ev is c for c in on_copy) for _, ev in waited)


def _declared_reads(caught) -> int:
    """The synchronising calls at the map's one declared read a chunk
    (``ops/tracepoints.py:host_read``, which ``models/wordcount.py:
    _read_flags`` goes through)."""
    path = REPO / "mapreduce_tpu_torch" / "ops" / "tracepoints.py"
    line = 1 + path.read_text().splitlines().index(
        "        return flags.tolist() if read is None else read(flags)")
    return sum(pathlib.Path(w.filename).resolve() == path
               and w.lineno == line and "synchroniz" in str(w.message)
               for w in caught)


@pytest.mark.cuda
def test_executor_adds_no_host_sync(cuda_device, tmp_path):
    """Under the sync debug mode, no synchronising call comes from the
    executor's own modules; the one read a chunk is ``_map_kernel``'s."""
    import warnings

    paths, _ = _stream_files(tmp_path, n_files=2)
    cfg = wc.Config(chunk_bytes=1 << 16)
    executor.count_file(paths, cfg)  # warm: build, allocate, pin
    job = wc.WordCountJob(cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rr = executor.run_job(job, paths, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [pathlib.Path(w.filename).resolve() for w in caught
             if "synchroniz" in str(w.message)]
    assert syncs, "the sync debug mode reported nothing"
    pkg = REPO / "mapreduce_tpu_torch"
    own = {pkg / f for f in ("runtime/executor.py", "data/reader.py",
                                "parallel/mapreduce.py", "obs/spans.py",
                                "native/__init__.py")}
    assert not [p for p in syncs if p in own]
    assert _declared_reads(caught) == rr.bases.shape[0]


def _sleep_cycles_per_ms() -> float:
    """``torch.cuda._sleep`` cycles a millisecond on this card, measured."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    end.synchronize()
    return 50_000_000 / start.elapsed_time(end)


@pytest.mark.cuda
def test_event_wait_times_out_then_completes(cuda_device):
    """A completion wait on a kernel still running raises TokenTimeout at
    its deadline (polling the event, not blocking on it); the same event
    is then waited for to its end."""
    from mapreduce_tpu_torch.runtime import faults

    stage = executor._PinnedStage(cuda_device, 1 << 10, 2)
    torch.cuda._sleep(int(300 * _sleep_cycles_per_ms()))  # ~0.3 s
    done = stage.completion()
    t0 = time.monotonic()
    with pytest.raises(faults.TokenTimeout):
        executor._wait_token(stage, done, 0.05)
    assert 0.05 <= time.monotonic() - t0 < 0.2
    assert not done.query()
    executor._wait_token(stage, done, 5.0)
    assert done.query()


@pytest.mark.cuda
def test_retry_pool_never_hands_out_a_held_buffer(cuda_device, tmp_path,
                                                   monkeypatch):
    """Under replays (a seeded plan at the completion waits and the
    dispatch, window 4, superstep 3, prefetch 16, 16 KB chunks), the pool
    never hands the reader a buffer a replayable group still holds, never
    runs dry, and the result is exact."""
    paths, joined = _stream_files(tmp_path)
    handed = []
    real_take = executor._PinnedStage.take

    def take(self):
        buf = real_take(self)
        with self._lock:
            assert buf.ctypes.data not in self._held
        handed.append(buf.ctypes.data)
        return buf

    monkeypatch.setattr(executor._PinnedStage, "take", take)
    cfg = wc.Config(chunk_bytes=1 << 14, inflight_groups=4,
                    prefetch_depth=16, superstep=3,
                    fault_plan="seed=5,rate=0.1,seams=token-wait+dispatch+"
                               "h2d,classes=transient,max=6")
    got = executor.count_file(paths, cfg, retry=3)
    assert got.as_dict() == oracle.word_counts(joined)
    pipe = got.run.pipeline
    assert pipe["recoveries"] >= 3
    assert len(handed) == got.run.bases.shape[0]
    # The reader's 16 and 2, and the held window: 4 groups of 3 and the
    # group being filled.
    assert pipe["pinned_buffers"] <= 16 + 2 + 5 * 3 - 1


@pytest.mark.cuda
def test_slow_kernel_replays_exactly(cuda_device, tmp_path):
    """A kernel that runs past ``token_timeout_s`` (a sleep queued after
    the first step's map) times its completion wait out; the replay queues
    behind it and the result is exact."""
    paths, joined = _stream_files(tmp_path, n_files=1)
    cfg = wc.Config(chunk_bytes=1 << 16, inflight_groups=1,
                    failure_policy={"transient_retries": 3,
                                    "token_timeout_s": 0.1,
                                    "backoff_base_s": 0.0})
    job = wc.WordCountJob(cfg)
    cycles = int(400 * _sleep_cycles_per_ms())  # ~0.4 s
    real_map = job.map_chunk
    calls = []

    def slow_map(chunk, chunk_id):
        out = real_map(chunk, chunk_id)
        if not calls:
            torch.cuda._sleep(cycles)
        calls.append(chunk_id)
        return out

    job.map_chunk = slow_map
    rr = executor.run_job(job, paths, cfg)
    got = executor.recover_from_file(rr.value, paths, rr.bases)
    assert got.as_dict() == oracle.word_counts(joined)
    assert rr.pipeline["recoveries"] >= 1
    assert calls.count(0) == 2  # step 0 ran, then its replay


@pytest.mark.cuda
def test_pinned_read_times_out_then_reads(cuda_device):
    """The map's bounded host read: flags computed behind a kernel still
    running raise TokenTimeout at the deadline (the read polls an event
    after a copy to pinned memory, it does not block); read again, they
    come back once the kernel is done."""
    from mapreduce_tpu_torch.runtime import faults

    stage = executor._PinnedStage(cuda_device, 1 << 10, 2)
    torch.cuda._sleep(int(300 * _sleep_cycles_per_ms()))  # ~0.3 s
    flags = torch.arange(1, 5, device=cuda_device)
    t0 = time.monotonic()
    with pytest.raises(faults.TokenTimeout):
        stage.read(flags, 0.05)
    assert time.monotonic() - t0 < 0.2
    assert stage.read(flags, 5.0) == [1, 2, 3, 4]


def _late_before_the_map(job, cycles: int, at_step: int) -> list:
    """Queue a ``cycles`` sleep on the compute stream before the first map
    of ``at_step``: its host read, and every later one, waits behind it.
    Returns the chunk ids the map saw."""
    real_map = job.map_chunk
    calls = []

    def slow_map(chunk, chunk_id):
        if chunk_id == at_step and at_step not in calls:
            torch.cuda._sleep(cycles)
        calls.append(chunk_id)
        return real_map(chunk, chunk_id)

    job.map_chunk = slow_map
    return calls


@pytest.fixture(scope="module")
def six_chunk_corpus(tmp_path_factory):
    """Six 32 MB chunks at ``Config()``: one text repeated (it ends with a
    separator, so the counts of the copies add)."""
    base = _zipf_text(31, 4 << 20) + b" "
    copies = -(-6 * wc.Config().chunk_bytes // len(base))
    path = tmp_path_factory.mktemp("late") / "corpus.txt"
    path.write_bytes(base * copies)
    return str(path), {w: copies * c
                       for w, c in oracle.word_counts(base).items()}


@pytest.mark.cuda
def test_a_hung_kernel_before_the_map_ends_in_token_timeout(
        cuda_device, six_chunk_corpus):
    """At ``Config()`` defaults (window 4), a kernel that outlasts the
    whole budget, queued before step 2's map: that map's host read times
    out, and so does each replay's, behind it; the run ends with a
    TokenTimeout while the kernel still runs, instead of stalling."""
    from mapreduce_tpu_torch.runtime import faults

    path, _ = six_chunk_corpus
    cfg = wc.Config(failure_policy={"transient_retries": 2,
                                    "token_timeout_s": 0.2,
                                    "backoff_base_s": 0.0})
    assert cfg.inflight_groups == 4
    job = wc.WordCountJob(cfg)
    hang_s = 6.0
    calls = _late_before_the_map(job, int(hang_s * 1e3
                                          * _sleep_cycles_per_ms()), 2)
    t0 = time.monotonic()
    with pytest.raises(faults.TokenTimeout):
        executor.run_job(job, path, cfg)
    elapsed = time.monotonic() - t0
    torch.cuda.synchronize()
    assert elapsed < hang_s / 2, elapsed
    # Step 0 ran, then its replay's three attempts (budget 2) timed out.
    assert calls.count(2) == 1 and calls.count(0) == 4


@pytest.mark.cuda
def test_a_late_kernel_before_the_map_replays_exactly(cuda_device,
                                                      six_chunk_corpus):
    """At ``Config()`` defaults (window 4), a kernel of ~0.6 s queued
    before step 2's map, past a ``token_timeout_s`` of 0.2 s: the host read
    times out, the replay waits it out on its budget, and the result is
    exact."""
    path, want = six_chunk_corpus
    cfg = wc.Config(failure_policy={"transient_retries": 3,
                                    "token_timeout_s": 0.2,
                                    "backoff_base_s": 0.0})
    job = wc.WordCountJob(cfg)
    calls = _late_before_the_map(job, int(600 * _sleep_cycles_per_ms()), 2)
    rr = executor.run_job(job, path, cfg)
    got = executor.recover_from_file(rr.value, path, rr.bases)
    assert got.as_dict() == want
    assert rr.pipeline["recoveries"] == 1
    assert calls.count(2) == 2  # step 2 ran, then its replay


def _telemetered(job, path, cfg, led, **kw):
    from mapreduce_tpu_torch.obs import ledger, registry, telemetry

    with telemetry.Telemetry.create(ledger_path=led,
                                    registry=registry.MetricsRegistry()) \
            as tel:
        rr = executor.run_job(job, path, cfg, telemetry=tel, **kw)
    return rr, list(ledger.read_ledger(led))


@pytest.mark.cuda
def test_telemetry_keeps_the_window_full_and_reads_memory(
        cuda_device, six_chunk_corpus, tmp_path):
    """At ``Config()`` (window 4), a ledger'd run's step records reach a
    depth of 4 and its window statistics are the untelemetered run's: the
    gauges and the memory reads add no wait.  Each step record carries
    the card's allocator counters; the data record counts every token."""
    path, want = six_chunk_corpus
    cfg = wc.Config()
    plain = executor.run_job(wc.WordCountJob(cfg), path, cfg)
    rr, recs = _telemetered(wc.WordCountJob(cfg), path, cfg,
                            str(tmp_path / "l.jsonl"))
    steps = [r for r in recs if r["kind"] == "step"]
    assert max(r["inflight_depth"] for r in steps) == 4
    for key in ("depth_max", "window_filled", "dispatch_groups"):
        assert rr.pipeline[key] == plain.pipeline[key], key
    assert all(r["mem"]["bytes_in_use"] > 0
               and r["mem"]["devices_reporting"] == 1 for r in steps)
    (data,) = [r for r in recs if r["kind"] == "data"]
    assert data["tokens"] == sum(want.values())
    assert data["chunks"] == rr.bases.shape[0] == 7
    got = executor.recover_from_file(rr.value, path, rr.bases)
    assert got.as_dict() == want


@pytest.mark.cuda
def test_group_gauges_are_read_after_the_event(cuda_device, tmp_path):
    """Window 4, superstep 3, small chunks: at every group the record's
    occupancy is the recount of the table of its steps, and its tokens the
    oracle's, so no gauge was read before the group's kernels ended."""
    paths, joined = _stream_files(tmp_path, n_files=1, n_bytes=1 << 20)
    cfg = wc.Config(chunk_bytes=1 << 16, table_capacity=1 << 14,
                    superstep=3)
    rr, recs = _telemetered(wc.WordCountJob(cfg), paths, cfg,
                            str(tmp_path / "l.jsonl"))
    from mapreduce_tpu_torch.data import reader as reader_mod
    from mapreduce_tpu_torch.parallel.mapreduce import Engine

    eng = Engine(wc.WordCountJob(cfg))
    state, valid = eng.init_states(), []
    for b in reader_mod.iter_batches_multi(paths, 1, cfg.chunk_bytes):
        state = eng.step(state, b.data, b.step)
        valid.append(int(state.n_valid()))
    groups = [r for r in recs if r["kind"] == "group"]
    assert len(groups) == rr.pipeline["dispatch_groups"] > 4
    assert [g["data"]["occupancy"] for g in groups] \
        == [round(valid[g["step_last"]] / cfg.table_capacity, 4)
            for g in groups]
    (data,) = [r for r in recs if r["kind"] == "data"]
    assert data["tokens"] == sum(oracle.word_counts(joined).values())


@pytest.mark.cuda
def test_telemetry_adds_no_host_sync(cuda_device, tmp_path):
    """Under the sync debug mode, a telemetered run's telemetry modules
    synchronise nothing; the map's one read a chunk stays the only one."""
    import warnings

    pkg = REPO / "mapreduce_tpu_torch"
    paths, _ = _stream_files(tmp_path, n_files=2)
    cfg = wc.Config(chunk_bytes=1 << 16)
    _telemetered(wc.WordCountJob(cfg), paths, cfg, str(tmp_path / "w.jsonl"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rr, _ = _telemetered(wc.WordCountJob(cfg), paths, cfg,
                                 str(tmp_path / "l.jsonl"))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [pathlib.Path(w.filename).resolve() for w in caught
             if "synchroniz" in str(w.message)]
    own = {pkg / f for f in ("runtime/executor.py", "data/reader.py",
                                "parallel/mapreduce.py", "obs/spans.py",
                                "obs/telemetry.py", "obs/ledger.py",
                                "obs/flight.py", "ops/datastats.py",
                                "native/__init__.py")}
    assert not [p for p in syncs if p in own]
    assert _declared_reads(caught) == rr.bases.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"sort_impl": "radix"},
                                {"map_impl": "fused"}])
def test_ngrams_on_the_card_equal_the_cpu(cuda_device, kw):
    """``count_ngrams`` on the card (one ``tokenize_stream`` launch, K2
    under the radix sort) equals the plain versions on the CPU, the
    overlong tokens' grams dropped alike."""
    corpus = _zipf_text(5, 1 << 20)
    cfg = wc.Config(**kw)
    for n in (2, 3):
        ktok.LAUNCHES.clear()
        radix.LAUNCHES.clear()
        got = wc.count_ngrams(corpus, n, cfg)
        want = wc.count_ngrams(corpus, n, cfg, device="cpu")
        for f in ("words", "counts", "total", "distinct", "dropped_uniques",
                  "dropped_count"):
            assert getattr(got, f) == getattr(want, f), (n, f)
        assert got.dropped_count > 0  # the 40- and 70-byte words
        mode = "tokenize_fused" if kw.get("map_impl") else "tokenize_pair"
        assert ktok.LAUNCHES[mode] == 1
        assert radix.LAUNCHES["radix_partition"] \
            == (2 if kw.get("sort_impl") else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"ngram": 2}, {"ngram": 3},
                                {"distinct_sketch": True},
                                {"ngram": 2, "count_sketch": True}])
def test_streamed_families_on_the_card_equal_the_cpu(cuda_device, tmp_path,
                                                     kw):
    paths, _ = _stream_files(tmp_path)
    cfg = wc.Config(chunk_bytes=1 << 16, sketch_flush_every=3)
    got = executor.count_file(paths, cfg, **kw)
    want = executor.count_file(paths, cfg, device="cpu", **kw)
    for f in ("words", "counts", "total", "distinct", "dropped_uniques",
              "dropped_count", "distinct_estimate"):
        assert getattr(got, f) == getattr(want, f), f
    if "count_sketch" in kw:
        assert np.array_equal(got.cms, want.cms)


@pytest.mark.cuda
@pytest.mark.parametrize("make", ["ngram", "batched_sketch"])
def test_families_read_the_host_once_a_chunk(cuda_device, tmp_path, make):
    """Under the sync debug mode a streamed n-gram run and a batched
    sketch run synchronise in the map's one read a chunk
    (``models/wordcount.py``), and never in the executor, the seam carry
    or the sketches."""
    import warnings

    paths, _ = _stream_files(tmp_path, n_files=2)
    cfg = wc.Config(chunk_bytes=1 << 16, sketch_flush_every=4)
    job = wc.NGramCountJob(2, cfg) if make == "ngram" \
        else wc.FreqSketchedWordCountJob(wc.WordCountJob(cfg))
    executor.run_job(job, paths, cfg)  # warm: build, allocate, pin
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rr = executor.run_job(job, paths, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [pathlib.Path(w.filename).resolve() for w in caught
             if "synchroniz" in str(w.message)]
    pkg = REPO / "mapreduce_tpu_torch"
    own = {pkg / f for f in ("runtime/executor.py", "data/reader.py",
                             "parallel/mapreduce.py", "ops/ngram.py",
                             "ops/sketch.py")}
    assert not [p for p in syncs if p in own]
    assert _declared_reads(caught) == rr.bases.shape[0]


@pytest.mark.cuda
def test_grep_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """Grep's torch map on the card (literal, class and newline patterns,
    one buffer and a streamed corpus of 64 KB chunks) equals the CPU's;
    it launches no hand-written kernel."""
    from mapreduce_tpu_torch.models import grep

    corpus = _zipf_text(7, 1 << 20)
    for pats, syntax in (([b"w1", b"\nw", b"w2\n", b"\n"], "literal"),
                         ([b"w[0-9a-f]", b"[^ ]\t"], "class")):
        ktok.LAUNCHES.clear()
        got = grep.grep_bytes_multi(corpus, pats, syntax)
        assert got == grep.grep_bytes_multi(corpus, pats, syntax,
                                            device="cpu")
        assert got[0].matches > 0 and not ktok.LAUNCHES
    paths, _ = _stream_files(tmp_path)
    cfg = wc.Config(chunk_bytes=1 << 16)
    got = grep.grep_file_multi(paths, [b"w1", b"\nw", b" w"], cfg)
    assert got == grep.grep_file_multi(paths, [b"w1", b"\nw", b" w"], cfg,
                                       device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 16, 4096])
def test_sample_on_the_card_equals_the_cpu(cuda_device, tmp_path, k):
    """The sample's kernel map (pair mode, the dense stream masked past
    its live rows, which the kernel leaves unwritten) equals the plain
    version's on the CPU, one launch a chunk."""
    from mapreduce_tpu_torch.models import sample

    corpus = _zipf_text(8, 1 << 20)
    cfg = wc.Config()
    ktok.LAUNCHES.clear()
    got = sample.sample_bytes(corpus, k, cfg)
    assert got == sample.sample_bytes(corpus, k, cfg, device="cpu")
    assert dict(ktok.LAUNCHES) == {"tokenize_pair": 1}
    paths, _ = _stream_files(tmp_path)
    cfg = wc.Config(chunk_bytes=1 << 16)
    ktok.LAUNCHES.clear()
    got = sample.sample_file(paths, k, cfg)
    launched = ktok.LAUNCHES["tokenize_pair"]
    assert got == sample.sample_file(paths, k, cfg, device="cpu")
    assert launched == len(list(reader_mod.iter_batches_multi(
        paths, 1, cfg.chunk_bytes)))


@pytest.mark.cuda
@pytest.mark.parametrize("make", ["grep", "sample"])
def test_grep_and_sample_never_read_the_host_in_a_step(cuda_device, tmp_path,
                                                       make):
    """Under the sync debug mode a streamed grep or sample synchronises
    nowhere in its map, its combine or the executor."""
    import warnings

    from mapreduce_tpu_torch.models import grep, sample

    paths, _ = _stream_files(tmp_path, n_files=2)
    cfg = wc.Config(chunk_bytes=1 << 16)
    job = grep.MultiGrepJob([b"w1", b"\nw"]) if make == "grep" \
        else sample.ReservoirSampleJob(64, cfg)
    executor.run_job(job, paths, cfg)  # warm: build, allocate, pin
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            executor.run_job(job, paths, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [pathlib.Path(w.filename).resolve() for w in caught
             if "synchroniz" in str(w.message)]
    pkg = REPO / "mapreduce_tpu_torch"
    own = {pkg / f for f in ("runtime/executor.py", "data/reader.py",
                             "parallel/mapreduce.py", "models/grep.py",
                             "models/sample.py", "models/wordcount.py",
                             "ops/cuda/tokenize.py", "ops/table.py",
                             "ops/tokenize.py")}
    assert not [p for p in syncs if p in own]


@pytest.mark.cuda
def test_grep_records_on_the_card_equal_the_cpu(cuda_device, tmp_path):
    """Records mode on the card (the emit's compaction and its copy into
    pinned memory, read after the stream) equals the CPU's at 64 KB
    chunks, a replayed group included; in the stream its one sync a chunk
    is the declared count read (``ops/tracepoints.py``)."""
    import warnings

    from mapreduce_tpu_torch.models import grep

    paths, _ = _stream_files(tmp_path, n_files=2)
    cfg = wc.Config(chunk_bytes=1 << 16, superstep=2, inflight_groups=2)
    want = grep.grep_records(paths, b"w1", cfg, device="cpu")
    assert want.lines > 100
    for retry, plan in ((0, None), (1, "at=token-wait:3:transient")):
        got = grep.grep_records(
            paths, b"w1", wc.Config(chunk_bytes=1 << 16, superstep=2,
                                    inflight_groups=2, fault_plan=plan),
            retry=retry)
        assert (got.records, got.matches, got.lines) \
            == (want.records, want.matches, want.lines)
    job = grep.GrepRecordsJob(b"w1")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rr = executor.run_job(job, paths, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [pathlib.Path(w.filename).resolve() for w in caught
             if "synchroniz" in str(w.message)]
    pkg = REPO / "mapreduce_tpu_torch"
    own = {pkg / f for f in ("runtime/executor.py", "data/reader.py",
                             "parallel/mapreduce.py", "models/grep.py")}
    assert not [p for p in syncs if p in own]
    assert 1 <= len([p for p in syncs if p == pkg / "ops/tracepoints.py"]) \
        <= rr.bases.size
