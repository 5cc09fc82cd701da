"""The port on the card: the CUDA kernel against its plain version.

Every test here needs an NVIDIA card and carries the ``cuda`` marker; where
``torch.cuda.is_available()`` is false each one skips with the reason.  The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest sets up JAX.)  Comparisons are
exact, tolerance zero: the kernel hashes and counts integers.
"""

import pathlib

import numpy as np
import pytest
import torch

from mapreduce_tpu_torch.models import wordcount as wc
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


def _edges(n: int) -> bytes:
    """Runs of W-1, W, W+1 and 3W bytes against every window edge and at
    both ends of the chunk."""
    buf = bytearray((b"ab cd " * (n // 6 + 1))[:n])
    runs = [W - 1, W, W + 1, 3 * W]
    for i, edge in enumerate(range(ktok.WINDOW, n - 4 * W, ktok.WINDOW)):
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
    "dense": lambda: b"a b " * (1 << 16),
    "tiny": lambda: b"hello",
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("slots", [ktok.COMPACT_SLOTS, ktok.PAIR_SLOTS])
def test_kernel_matches_plain_version(cuda_device, case, slots):
    data = torch.frombuffer(bytearray(CASES[case]()), dtype=torch.uint8)
    data = data.to(cuda_device)
    want = ktok.tokenize_windows_plain(data, W, slots)
    got = ktok.tokenize_windows_kernel(data, W, slots)
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a.cpu(), b.cpu())
    if slots == ktok.PAIR_SLOTS:
        assert int(got[5]) == 0  # pair mode never spills
    if case == "dense" and slots == ktok.COMPACT_SLOTS:
        assert int(got[5]) > 0


@pytest.mark.cuda
def test_wrappers_count_launches_and_check_input(cuda_device):
    data = torch.frombuffer(bytearray(CASES["zipf"]()), dtype=torch.uint8)
    data = data.to(cuda_device)
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
