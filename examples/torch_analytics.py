"""The PyTorch port's model families in one script: n-grams, frequency
sketch, grep and the sample.

    python examples/torch_analytics.py [path] [--platform cpu]

- Bigram counts: `--ngram 2` semantics (order-sensitive token pairs, reported
  as their exact first-occurrence source spans).
- Count-Min frequency estimates: query ANY word or phrase after the run,
  including ones the exact table spilled past capacity.
- Grep: overlapping occurrences + matching lines of a pattern.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile

from mapreduce_tpu_torch.config import Config
from mapreduce_tpu_torch.models import grep, sample
from mapreduce_tpu_torch.runtime import executor

p = argparse.ArgumentParser()
p.add_argument("path", nargs="?")
p.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
args = p.parse_args()
device = "cpu" if args.platform == "cpu" else None

if args.path:
    path = args.path
else:  # demo corpus
    f = tempfile.NamedTemporaryFile(suffix=".txt", delete=False)
    f.write(b"the quick brown fox jumps over the lazy dog\n" * 200
            + b"the quick red fox naps\n" * 50)
    f.close()
    path = f.name

cfg = Config(chunk_bytes=1 << 20, table_capacity=1 << 14)

# Bigrams, top 5 by frequency.
bi = executor.count_file(path, config=cfg, device=device, ngram=2, top_k=5)
print("top bigrams:")
for span, count in bi.as_dict().items():
    print(f"  {span.decode()!r}\t{count}")

# Frequency sketch: estimates survive table overflow.  The sketch keys
# match the run's gram order: query words on a unigram run, spans on an
# n-gram run.
r = executor.count_file(path, config=cfg, device=device, count_sketch=True)
for q in (b"the", b"fox", b"not-in-corpus"):
    print(f"estimate {q.decode()!r}: {r.estimate_count(q)}")
r2 = executor.count_file(path, config=cfg, device=device, ngram=2,
                         count_sketch=True)
print(f"estimate 'quick brown' (bigram run): {r2.estimate_count(b'quick brown')}")

# Grep.
g = grep.grep_file(path, b"quick", config=cfg, device=device)
print(f"grep 'quick': {g.matches} matches on {g.lines} lines")

# Multi-pattern grep: P patterns share ONE pass over the corpus.
for pat, res in zip(["quick", "fox", "zebra"],
                    grep.grep_file_multi(path, [b"quick", b"fox", b"zebra"],
                                         config=cfg, device=device)):
    print(f"multigrep {pat!r}: {res.matches} matches on {res.lines} lines")

# Regex-lite byte classes: fixed-length per-position allowed-sets.
c = grep.grep_file(path, b"[a-z]o[gx]", config=cfg, device=device,
                   syntax="class")
print(f"grep class '[a-z]o[gx]': {c.matches} matches ('dog'/'fox' tails)")

# Uniform sampling: a mergeable bottom-k sketch over token occurrences.
s = sample.sample_file(path, 8, config=cfg, device=device)
print(f"uniform sample of {len(s.tokens)} from {s.total} tokens: "
      + " ".join(t.decode() for t in s.tokens))
