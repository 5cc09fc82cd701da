"""The port's share of the JAX package's ``analysis/``: so far only the
``geometry='auto'`` resolution (:mod:`.geometry`)."""
