"""Several ranks on the card.

Every test here needs an NVIDIA card and carries the ``cuda`` marker;
where ``torch.cuda.is_available()`` is false each one skips with the
reason.  The file imports only the port (no JAX), so the card machine
runs it as it is::

    python -m pytest tests/test_torch_cuda_ranks.py -m cuda --noconftest -q

A gloo world of 2 ranks, both on card 0 (the kernels on the card, the
collectives through the host: NCCL refuses two ranks on one card), run
through the CLI (``tests/torch_world.py``), prints what one rank prints
on the card: the word count with each merge strategy, and the bigrams,
whose grams cross the join between the ranks' rows in every step.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import torch_world
from mapreduce_tpu_torch import cli


@pytest.fixture
def corpus(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.default_rng(41)
    vocab = [b"r%x" % i for i in range(400)] + [b"x" * 40]
    words = [vocab[int(i) % len(vocab)] for i in rng.zipf(1.3, 60000)]
    p = tmp_path / "c.txt"
    p.write_bytes(b" ".join(words))
    return str(p)


def _one_rank(argv) -> bytes:
    buf = io.TextIOWrapper(io.BytesIO(), encoding="utf-8",
                           write_through=True)
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return buf.buffer.getvalue()


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_equal_one_rank(corpus, tmp_path):
    flags = [corpus, "--stream", "--chunk-bytes", "65536", "--format",
             "json"]
    cases = [{"name": s, "kind": "cli",
              "args": {"argv": [*flags, "--merge-strategy", s]}}
             for s in ("tree", "gather", "keyrange")]
    cases.append({"name": "ngram", "kind": "cli",
                  "args": {"argv": [*flags, "--ngram", "2"]}})
    world = torch_world.spawn_world(2, cases, tmp_path / "w",
                                    platform="gpu")
    words, grams = _one_rank(flags), _one_rank([*flags, "--ngram", "2"])
    for s in ("tree", "gather", "keyrange"):
        assert world[0][s] == (0, words), s
        assert world[1][s] == (0, b"")
    assert world[0]["ngram"] == (0, grams)
