"""The offline drivers that write ``tuned.json``: each the counterpart of
one of the repository's ``tools/`` drivers, with its names and file
formats, over the port's own modules (they import no JAX, nothing of the
JAX package, and neither ``bench`` nor ``tools``).

* :mod:`.corpora` -- ``bench.py``'s four seeded synthetic corpora
  (``make_zipf_corpus``, ``make_natural_corpus``, ``make_webby_corpus``,
  ``make_markup_corpus``), byte for byte;
* :mod:`.autotune` -- ``tools/autotune.py``: the rule-table walk over
  measured probe passes, the ``wordcount/<platform>/...`` profile;
* :mod:`.geomsearch` -- ``tools/geomsearch.py``: the geometry shortlist,
  its analysis gate and the measured probe ranking, the
  ``wordcount-geometry/<platform>/...`` profile that ``--geometry auto``
  reads;
* :mod:`.redplan` -- ``tools/redplan.py``: the merge-strategy plan over
  the link model, its ledger prior, gate and check, the
  ``wordcount-redplan/static/...`` profile that ``--merge-strategy auto``
  reads.

Each runs as ``python -m mapreduce_tpu_torch.tools.<name>`` and in process
through its ``main(argv)``, on the card unless ``--platform cpu`` is
given.
"""
