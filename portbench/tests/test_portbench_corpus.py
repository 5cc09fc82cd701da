"""The generators: sizes, determinism by seed, and the work every seed
gets alike."""

import numpy as np

from portbench import corpus
from portbench.corpus import zipf_vocabulary
from portbench.reference import wordcount
from portbench.tests.conftest import config, small_corpus

BIG_SEED = 2**31 + 12345


def test_size_and_determinism(config_name):
    s = small_corpus(config_name)
    a = corpus.generate(s, BIG_SEED)
    assert a == corpus.generate(s, BIG_SEED)
    assert a != corpus.generate(s, BIG_SEED + 1)
    assert len(a) == s["bytes"]
    assert a[-1:] in (b" ", b"\n")
    assert corpus.generate(s, -3) == corpus.generate(s, 2**64 - 3)


def test_text8_counts_and_lengths_are_the_same_for_every_seed():
    s = small_corpus("wordcount-text8")
    shapes = []
    for seed in (1, BIG_SEED):
        c = wordcount.count(corpus.generate(s, seed))
        assert len(c) == s["distinct"]
        assert sum(c.values()) == s["tokens"]
        assert sum(len(w) > 32 for w in c) == s["long_words"]
        shapes.append((sorted(c.values()), sorted(map(len, c))))
    assert shapes[0] == shapes[1]


def test_text8_gather_is_the_words_joined_in_the_shuffled_order(
        monkeypatch):
    s = small_corpus("wordcount-text8")
    counts = zipf_vocabulary.zipf_counts(s)
    length = zipf_vocabulary.zipf_lengths(s, counts)
    rng = corpus.rng_for(BIG_SEED)
    flat, offset = zipf_vocabulary.zipf_words(length, rng)
    words = [flat[o:o + n + 1].tobytes() for o, n in zip(offset, length)]
    assert all(w.endswith(b" ") and b" " not in w[:-1] for w in words)
    order = np.repeat(np.arange(len(counts)), counts)
    rng.shuffle(order)
    joined = b"".join(words[r] for r in order)
    assert corpus.generate(s, BIG_SEED) == joined
    monkeypatch.setattr(zipf_vocabulary, "BLOCK_TOKENS", 7)
    assert corpus.generate(s, BIG_SEED) == joined


def test_text8_full_size_counts():
    s = config("wordcount-text8")["corpus"]
    c = zipf_vocabulary.zipf_counts(s)
    assert c.sum() == s["tokens"] and len(c) == s["distinct"]
    assert c.min() == 1 and np.all(np.diff(c) <= 0)
    assert abs(c[0] / s["tokens"] - 0.0624) < 0.002
