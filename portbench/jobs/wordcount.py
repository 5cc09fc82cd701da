"""The word count as a user runs it: ``count_file`` over the corpus's
paths, the whole count with its host string recovery (the ``recover``
phase of the returned ``RunResult``)."""


def run(paths: list, config, device: str, logger):
    """``(result, RunResult)`` of one whole job."""
    from mapreduce_tpu_torch.runtime.executor import count_file

    result = count_file(paths, config, device=device, logger=logger)
    return result, result.run
