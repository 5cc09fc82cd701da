"""One reader a metric: ``<name>.py`` defines ``read(run) -> float | None``
over a :class:`portbench.cell.Run`.  A reader that finds nothing to read
returns None, and the run leaves the metric out of its line."""
