"""The benchmark of the PyTorch and CUDA port (``mapreduce_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once; see its docstring,
and ``cell.py`` for how a cell's files are found by name.  Everything
that defines the yardstick lives here: the corpus generators
(``corpus/``), the plain references with their comparisons
(``reference/``), each configuration (``configs/``), each traffic mix
(``traffic/``) and the loop it names (``loops/``), each metric's reader
(``metrics/``), the table of peaks (``peaks.json``) and the judge that
decides ``correct`` (``check.py``).  The program is reached only through
``jobs/``.
"""
