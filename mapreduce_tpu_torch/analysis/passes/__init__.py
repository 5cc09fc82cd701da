"""Built-in graphcheck passes.  Import order = pipeline run order (the JAX
package's, without the mesh and race passes: ROADMAP A13b)."""

from mapreduce_tpu_torch.analysis.passes import (algebra, overflow, hostsync,
                                                 cost, smem, fusion)

__all__ = ["algebra", "overflow", "hostsync", "cost", "smem", "fusion"]
