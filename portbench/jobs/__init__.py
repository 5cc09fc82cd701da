"""The program's side of each kind of job, one file a kind, found by the
name a configuration's ``job`` key gives (the plain side is
``reference/<job>.py``): ``run(paths, config, device, logger)`` runs one
whole job and returns ``(result, RunResult)``."""
