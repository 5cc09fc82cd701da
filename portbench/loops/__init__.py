"""The loops that drive a window, one file a loop, found by the name a
traffic file's ``loop`` key gives.  ``loops/<loop>.py`` defines
``window(timed, seconds, traffic, traced) -> [Job]``:

- ``timed(traced)`` runs one whole job and returns its
  :class:`portbench.cell.Job` (host-clock start and end);
- ``traffic`` is the traffic file's object, the loop's parameters;
- ``traced`` is None, or a context (:class:`portbench.cell.Traced`) to
  run the window's first jobs inside, with ``traced.enough(jobs)``.

The window ends once ``seconds`` have passed since its first job began;
jobs begun by then finish.
"""
