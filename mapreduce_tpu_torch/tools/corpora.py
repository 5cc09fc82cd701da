"""The seeded synthetic corpora the offline drivers probe with.

The port's copy of the repository's bench generators (``bench.py``:
``make_zipf_corpus``, ``make_natural_corpus``, ``make_webby_corpus`` and
``make_markup_corpus``): numpy only, and the same bytes for the same size
and seed, so a profile written by either package's driver describes the
same corpus.  :data:`GENERATORS` maps the drivers' ``--corpus`` names to
them.
"""

from __future__ import annotations

import numpy as np


def make_zipf_corpus(n_bytes: int, vocab: int = 50_000, a: float = 1.3,
                     seed: int = 7) -> bytes:
    """Zipf(``a``) draws over ``vocab`` words ``w0``, ``w1``, ...: the
    skewed corpus whose hot keys the combiner absorbs."""
    rng = np.random.default_rng(seed)
    words = np.array([b"w%d" % i for i in range(vocab)], dtype=object)
    # Zipf draws skew short (w1, w2, ...), so bytes-per-word is corpus-
    # dependent: generate in slabs until the requested size is reached.
    parts, have = [], 0
    while have < n_bytes:
        idx = rng.zipf(a, size=1 << 20).astype(np.int64) % vocab
        slab = b" ".join(words[idx]) + b" "
        parts.append(slab)
        have += len(slab)
    blob = b"".join(parts)
    return blob[:n_bytes].rsplit(b" ", 1)[0] + b"\n"


# ~200 high-frequency English words: the head of a realistic unigram
# distribution (the tail is synthesized below with rarer, longer forms).
_COMMON = ("the of and to in a is that it was for on are as with his they at"
           " be this have from or one had by word but not what all were we"
           " when your can said there use an each which she do how their if"
           " will up other about out many then them these so some her would"
           " make like him into time has look two more write go see number"
           " no way could people my than first water been call who oil its"
           " now find long down day did get come made may part over new sound"
           " take only little work know place year live me back give most"
           " very after thing our just name good sentence man think say great"
           " where help through much before line right too mean old any same"
           " tell boy follow came want show also around form three small set"
           " put end does another well large must big even such because turn"
           " here why ask went men read need land different home us move try"
           " kind hand picture again change off play spell air away animal"
           " house point page letter mother answer found study still learn"
           " should america world high every near add food between own below"
           " country plant last school father keep tree never start city"
           " earth eye light thought head under story saw left dont few while"
           " along might close something seem next hard open example begin"
           " life always those both paper together got group often run").split()


def make_natural_corpus(n_bytes: int, seed: int = 11) -> bytes:
    """English-like text proxy (enwik8 stand-in: nothing real is mountable).

    Unlike the pure-Zipf corpus, this has the statistics that stress the
    pipeline the way natural text does: punctuation attached to words (so
    ``word`` / ``word,`` / ``word.`` are distinct tokens), sentence-initial
    capitalization (more distinct casings), a heavy head of short common
    words plus a long tail of rarer coined forms, variable sentence and
    paragraph lengths, and occasional markup-ish tokens.  Fully vectorized
    per slab (numpy choice + np.char ops), so generation stays small next
    to the passes it feeds.
    """
    rng = np.random.default_rng(seed)
    head = np.array(_COMMON)
    tail = np.array([f"{head[i % len(head)]}{head[(i * 7 + 3) % len(head)]}"
                     + ("ing" if i % 3 else "s") for i in range(20_000)])
    parts: list[bytes] = []
    have = 0
    slab_n = 200_000  # words per vectorized slab (~1.1 MB)
    while have < n_bytes:
        words = np.where(rng.random(slab_n) < 0.18,
                         tail[rng.integers(0, len(tail), size=slab_n)],
                         head[rng.integers(0, len(head), size=slab_n)])
        # Sentence ends (~every 12 words); the following word starts a
        # sentence and is capitalized.
        ends = rng.random(slab_n) < (1 / 12)
        starts = np.concatenate([[True], ends[:-1]])
        words[starts] = np.char.capitalize(words[starts])
        # Markup-ish tokens replace ~0.5% of words.
        mk = rng.random(slab_n) < 0.005
        words[mk] = np.where(rng.random(int(mk.sum())) < 0.5,
                             "[[link]]", "&quot;")
        # Punctuation: terminal . / ? at ends, commas mid-sentence.
        r = rng.random(slab_n)
        suffix = np.where(ends, np.where(r < 0.9, ".", "?"),
                          np.where(r < 0.06, ",", ""))
        # Paragraph breaks after ~12% of sentence ends.
        sep = np.where(ends & (rng.random(slab_n) < 0.12), "\n", " ")
        slab = "".join(np.char.add(np.char.add(words, suffix), sep).tolist()) \
            .encode()
        parts.append(slab)
        have += len(slab)
    return b"".join(parts)[:n_bytes].rsplit(b" ", 1)[0] + b"\n"


def make_webby_corpus(n_bytes: int, seed: int = 23) -> bytes:
    """Natural-text proxy with an enwik-like long-token tail.

    enwik8 (wikipedia XML) carries URLs, wiki-link paths and attribute blobs
    far beyond the kernel's W=32 window; WET Common-Crawl text adds
    base64-ish junk.  ~0.3% of words here become such tokens (enwik8
    ballpark: 0.1-0.5% of whitespace-delimited tokens exceed 32 bytes),
    lengths log-uniform in [33, 300] — the corpus that exercises the
    overlong rescue (``ops/rescue.py``), which the other generators never
    reach.
    """
    rng = np.random.default_rng(seed)
    words = make_natural_corpus(n_bytes, seed=seed).split(b" ")
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789./_-=&?",
                          np.uint8)
    # Splice URLs at ~0.3% of sites: touch only the chosen sites (one draw
    # of all URL bytes up front), not every word.
    sites = np.flatnonzero(rng.random(len(words)) < 0.003)
    lengths = np.exp(rng.uniform(np.log(33), np.log(300),
                                 size=len(sites))).astype(np.int64)
    blob = alpha[rng.integers(0, len(alpha), int(lengths.sum()))].tobytes()
    ends = np.cumsum(lengths)
    for i, site in enumerate(sites):
        words[site] = b"http://" + blob[ends[i] - lengths[i]:ends[i]]
    return b" ".join(words)[:n_bytes]


def make_markup_corpus(n_bytes: int, seed: int = 31) -> bytes:
    """enwik-like markup proxy: the hostile-input stand-in (the other
    generators are clean ASCII).

    Structured like wikipedia XML dumps: nested tags with attribute blobs,
    ``[[wiki links|display text]]``, ``&entities;``, UTF-8 MULTIBYTE words
    (Latin-1 accents, Greek, CJK — continuation bytes >= 0x80 must never
    split tokens), URLs past the W=32 window, and occasional very long
    separator-free attribute runs that exercise the reader's force-split.
    Tokens here are what the framework's whitespace semantics see — e.g.
    ``<title>Αθήνα</title>`` is ONE token — matching how the reference
    would tokenize the same bytes.
    """
    rng = np.random.default_rng(seed)
    latin = ["café", "naïve", "über", "résumé",
             "Zürich", "élève"]
    greek = ["Αθήνα", "λόγος"]
    cjk = ["東京", "中文", "日本語"]
    plain = _COMMON
    ents = ["&amp;", "&lt;", "&gt;", "&quot;", "&#945;"]
    parts, have = [], 0
    while have < n_bytes:
        page = ["<page>\n  <title>",
                str(rng.choice(plain)).capitalize(),
                "</title>\n  <revision id=\"",
                str(int(rng.integers(1e6, 1e8))), "\">\n    <text>"]
        for _ in range(int(rng.integers(40, 120))):
            r = rng.random()
            if r < 0.72:
                page.append(str(rng.choice(plain)))
            elif r < 0.82:
                page.append(str(rng.choice(latin + greek + cjk)))
            elif r < 0.88:
                page.append("[[" + str(rng.choice(plain)) + "|"
                            + str(rng.choice(plain)) + "]]")
            elif r < 0.93:
                page.append(str(rng.choice(ents)))
            elif r < 0.97:
                page.append("http://example.org/wiki/"
                            + "/".join(str(rng.choice(plain))
                                       for _ in range(int(rng.integers(2, 7)))))
            else:  # long separator-free attribute blob (force-split fodder)
                n = int(rng.integers(40, 400))
                page.append("style=\"" + "a" * n + "\"")
            page.append("\n" if rng.random() < 0.1 else " ")
        page.append("</text>\n  </revision>\n</page>\n")
        slab = "".join(page).encode("utf-8")
        parts.append(slab)
        have += len(slab)
    return b"".join(parts)[:n_bytes].rsplit(b" ", 1)[0] + b"\n"


#: ``--corpus`` name -> generator (size in bytes -> corpus bytes).
GENERATORS = {"zipf": make_zipf_corpus,
              "natural": make_natural_corpus,
              "webby": make_webby_corpus,
              "markup": make_markup_corpus}
