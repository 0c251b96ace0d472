"""sheep_tpu_torch.server — the served engine (the port's counterpart of
``sheep_tpu/server/``): the partitioner as a long-lived process that
holds its loaded kernels, its chunk cache and a queue of jobs.

- :mod:`~sheep_tpu_torch.server.daemon` — ``sheepd``
  (``python -m sheep_tpu_torch.cli serve``), serving partition requests
  over a local unix socket or TCP, with ``/metrics`` over HTTP;
- :mod:`~sheep_tpu_torch.server.scheduler` — admission against the
  card's memory model, and the dispatch loop that steps the admitted
  jobs round-robin on one thread, each job's groups folding into its own
  table;
- :mod:`~sheep_tpu_torch.server.engine` — one job as a step generator
  over the port's batched build (degrees, sort, build, split, score);
- :mod:`~sheep_tpu_torch.server.protocol` — the JSON wire protocol, the
  reference's byte for byte;
- :mod:`~sheep_tpu_torch.server.client` — ``SheepClient`` and the
  ``submit`` and ``update`` verbs;
- :mod:`~sheep_tpu_torch.server.journal` and
  :mod:`~sheep_tpu_torch.server.resultstore` — the job journal and the
  content-addressed result store of a ``--state-dir`` daemon.

A served job's forest, assignment and scores are those of the port's CLI
build of the same input and of the reference's served job. The jobs run
on CUDA unless the daemon is given ``--device cpu`` (``Scheduler(
device="cpu")``); without a GPU the default raises.
"""

from sheep_tpu_torch.server.protocol import JOB_STATES, JobSpec  # noqa: F401


def __getattr__(name):
    # the scheduler pulls in the engine and the backends; the client and
    # the protocol stay importable without them
    if name == "Scheduler":
        from sheep_tpu_torch.server.scheduler import Scheduler

        return Scheduler
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
