"""The sharded multi-device build: the shard mesh and its collectives
(:mod:`~sheep_tpu_torch.parallel.mesh`) and the pipeline over it
(:mod:`~sheep_tpu_torch.parallel.pipeline`)."""
