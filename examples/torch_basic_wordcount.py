"""Smallest possible use of the PyTorch port: exact word counts for an
in-memory buffer, on the card.

    python examples/torch_basic_wordcount.py [--platform cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mapreduce_tpu_torch.models import wordcount

p = argparse.ArgumentParser()
p.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
device = "cpu" if p.parse_args().platform == "cpu" else None

text = b"to be or not to be that is the question"
result = wordcount.count_words(text, device=device)

for word, count in zip(result.words, result.counts):  # insertion order
    print(f"{word.decode()}\t{count}")
print(f"total={result.total} distinct={result.distinct}")
assert result.as_dict()[b"to"] == 2
