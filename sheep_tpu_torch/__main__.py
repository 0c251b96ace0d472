"""``python -m sheep_tpu_torch`` == ``python -m sheep_tpu_torch.cli``: how
the processes of a multi-process run are launched."""

from sheep_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
