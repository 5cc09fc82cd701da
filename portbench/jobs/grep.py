"""The grep task as a user runs it: ``grep_records`` over the corpus's
paths, the matching records with their counts, and the host's recovery of
the records (the ``recover`` phase of the returned ``RunResult``)."""

#: The pattern of the Pavlo et al. grep task (the configuration's
#: ``corpus.pattern``, which the generator plants).
PATTERN = b"XYZ"


def run(paths: list, config, device: str, logger):
    """``(result, RunResult)`` of one whole job."""
    from mapreduce_tpu_torch.models.grep import grep_records

    result = grep_records(paths, PATTERN, config, device=device,
                          logger=logger)
    return result, result.run
