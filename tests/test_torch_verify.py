"""The port's exact host recount (``utils/verify.py``), the key-collision
detection path, against the JAX package's copy and an oracle.

An injected collision (the hash finalizer collapsed to 4 bits, so many
distinct words share a key) must be caught, as in ``tests/test_verify.py``.
"""

import pytest

from mapreduce_tpu.utils import verify as jverify
from mapreduce_tpu_torch import cli
from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.models import wordcount as wc
from mapreduce_tpu_torch.ops import tokenize as tok_ops
from mapreduce_tpu_torch.utils import oracle
from mapreduce_tpu_torch.utils.verify import recount_exact, verify_result
from tests.conftest import make_corpus


def test_recount_exact_matches_oracle_and_jax(tmp_path, rng):
    corpus = make_corpus(rng, n_words=5000, vocab=200)
    p = tmp_path / "c.txt"
    p.write_bytes(corpus)
    want = oracle.word_counts(corpus)
    some = list(want)[:50]
    got = recount_exact(str(p), some, chunk_bytes=512)  # many carry seams
    assert got == {w: want[w] for w in some}
    assert got == jverify.recount_exact(str(p), some, chunk_bytes=512)


def test_recount_exact_multi_file_and_unterminated_tail(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_bytes(b"x y x")  # no trailing separator: the tail token counts
    b.write_bytes(b"x z")
    got = recount_exact([str(a), str(b)], [b"x", b"y", b"z"])
    assert got == {b"x": 3, b"y": 1, b"z": 1}


def test_verify_result_passes_on_honest_run(tmp_path, rng):
    corpus = make_corpus(rng, n_words=4000, vocab=100)
    p = tmp_path / "c.txt"
    p.write_bytes(corpus)
    r = wc.count_words(corpus, Config(chunk_bytes=1 << 15,
                                      table_capacity=4096), device="cpu")
    assert verify_result(r.words, r.counts, str(p), sample=32) == []
    assert jverify.verify_result(r.words, r.counts, str(p), sample=32) == []


def test_injected_collision_is_detected(tmp_path, rng, monkeypatch):
    """Collapse the hash finalizer to 4 bits: distinct words share 64-bit
    keys, the table merges them (summed counts under one identity), and
    the exact recount flags it, as the JAX copy does."""
    corpus = make_corpus(rng, n_words=3000, vocab=300)
    p = tmp_path / "c.txt"
    p.write_bytes(corpus)
    real_fmix = tok_ops._fmix32
    monkeypatch.setattr(tok_ops, "_fmix32", lambda x: real_fmix(x) & 0xF)
    r = wc.count_words(corpus, Config(chunk_bytes=1 << 15,
                                      table_capacity=4096, backend="xla"),
                       device="cpu")
    monkeypatch.undo()
    true_counts = oracle.word_counts(corpus)
    assert len(r.words) < len(true_counts)
    assert r.total == sum(true_counts.values())
    mismatches = verify_result(r.words, r.counts, str(p), sample=64)
    assert mismatches, "collision went undetected"
    assert mismatches == jverify.verify_result(r.words, r.counts, str(p),
                                               sample=64)
    for w, reported, true in mismatches:
        assert reported > true


@pytest.mark.parametrize("sample", [3, 100])
def test_cli_verify_sample(sample, capsys, monkeypatch, tmp_path):
    """``--verify-sample K`` after a word-count run: the JAX CLI's stderr
    line; a collision exits 4 with a MISMATCH line per word."""
    p = tmp_path / "t.txt"
    p.write_bytes(b"Hello World EveryOne\nWorld Good News\nGood Morning "
                  b"Hello\n")
    assert cli.main([str(p), "--platform", "cpu", "--no-echo",
                     "--verify-sample", str(sample)]) == 0
    err = capsys.readouterr().err
    assert f"verify: ok ({min(sample, 6)} words recounted exactly)" in err
    real_fmix = tok_ops._fmix32
    monkeypatch.setattr(tok_ops, "_fmix32", lambda x: real_fmix(x) & 0x1)
    assert cli.main([str(p), "--platform", "cpu", "--no-echo",
                     "--backend", "xla", "--verify-sample",
                     str(sample)]) == 4
    assert "verify: MISMATCH" in capsys.readouterr().err
