"""``Config.geometry='auto'`` resolution: the counterpart of
``resolve_auto`` in the JAX package's ``analysis/geometry.py``.

Only that function is ported.  The rest of the JAX module (the geometry
candidates, their static cost model and the shortlist) reads the TPU
kernels' block layout, and is ROADMAP item A13's.
"""

from __future__ import annotations

from mapreduce_tpu_torch.config import GEOMETRY_PRESETS, Geometry
from mapreduce_tpu_torch.obs import history


def resolve_auto(profile_path: str, family: str = "wordcount"):
    """Resolve ``Config.geometry='auto'`` against a searched profile: the
    freshest ``tuned.json`` profile for ``family`` whose config carries a
    non-default geometry decides, as its preset label or spec dict (the
    ``Config`` takes both).  No profile, no geometry entry or an
    unreadable file resolves to ``'default'``.  The read is
    ``history.resolve_prior``'s; this wrapper adds the ``Config``-side
    check of a spec dict (a dict ``Geometry`` refuses is skipped)."""

    def _valid_spec(spec: dict) -> bool:
        try:
            Geometry(**spec)
        except (TypeError, ValueError):
            return False
        return True

    return history.resolve_prior(
        profile_path=profile_path, family=family,
        presets=set(GEOMETRY_PRESETS), geometry_ok=_valid_spec)["geometry"]
