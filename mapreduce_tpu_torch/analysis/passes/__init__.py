"""Built-in graphcheck passes.  Import order = pipeline run order (the JAX
package's, with ``smem`` for its ``vmem``)."""

from mapreduce_tpu_torch.analysis.passes import (algebra, overflow, hostsync,
                                                 sharding, cost, smem,
                                                 kernelrace, fusion,
                                                 collective)

__all__ = ["algebra", "overflow", "hostsync", "sharding", "cost", "smem",
           "kernelrace", "fusion", "collective"]
