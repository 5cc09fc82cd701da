"""Process start to the first timed job: imports, the card's start, the
corpus generated and written, kernel builds where the checkout has none,
and the warm-up job (host clock)."""


def read(run):
    return run.setup_s
