"""The plain reference against itself by hand and against the port's
``count_file`` on the CPU at small sizes."""

from portbench import corpus
from portbench.reference import wordcount
from portbench.tests.conftest import PROGRAM, small_corpus


def test_separators_and_order():
    data = b"b a\x00b\tc\nA\x0bb\x0cc\rd  a "
    c = wordcount.count(data)
    assert list(c.items()) == [(b"b", 3), (b"a", 2), (b"c", 2), (b"A", 1),
                               (b"d", 1)]


def test_blocks_never_cut_a_token(monkeypatch):
    data = b"abc defg hij " * 50
    whole = wordcount.count(data)
    monkeypatch.setattr(wordcount, "BLOCK", 7)
    assert wordcount.count(data) == whole
    assert list(wordcount.count(data)) == list(whole)


def test_expected_scales_a_listed_part():
    words, counts, total = wordcount.expected(b"x y x\n", 3)
    assert (words, counts, total) == ([b"x", b"y"], [6, 3], 9)


def test_reference_matches_the_port_on_the_cpu(config_name, tmp_path):
    from mapreduce_tpu_torch.config import Config
    from mapreduce_tpu_torch.runtime.executor import count_file

    part = corpus.generate(small_corpus(config_name), 99)
    path = tmp_path / "part.txt"
    path.write_bytes(part)
    got = count_file([str(path)] * 2, Config(**PROGRAM), device="cpu")
    words, counts, total = wordcount.expected(part, 2)
    assert got.words == words
    assert got.counts == counts
    assert (got.total, got.distinct) == (total, len(words))
