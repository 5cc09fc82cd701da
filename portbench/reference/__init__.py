"""Plain references, one file a kind of job, found by the name a
configuration's ``job`` key gives.  Each owns its comparison: see
``wordcount.py`` for what a reference file gives."""
