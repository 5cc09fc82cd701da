"""``python -m mapreduce_tpu_torch file [file...]``: the port's CLI."""

from mapreduce_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
