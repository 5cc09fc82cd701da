"""Declared host syncs a chunk: the process registry's
``executor.host_syncs`` (every site) over ``executor.chunks``, both
counted at the step over every job the process ran (layer: streamed
driver).  A count: it repeats exactly for one input.  None where the
program keeps no such counters."""


def read(run):
    from mapreduce_tpu_torch.obs import registry

    counters = registry.get_registry().snapshot()["counters"]
    chunks = counters.get("executor.chunks")
    if not chunks:
        return None
    return sum(v for k, v in counters.items()
               if k.startswith("executor.host_syncs{")) / chunks
