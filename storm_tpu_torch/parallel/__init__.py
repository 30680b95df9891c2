"""Parallelism of the port, the counterpart of ``storm_tpu/parallel/``:
a mesh of ranks (``mesh``) and the collectives over its axes
(``collectives``); the placement of a batch and of parameters
(``sharding``: data parallelism, Megatron tensor parallelism); ring
attention and sequence-parallel encoder blocks (``ring_attention``,
``sequence``); the mixture-of-experts layer, at one expert shard or with
its experts split over ranks (``moe``); spawning a world of rank
processes (``launch``); and the one-device training step (``train``).
Sharded training and the pipeline (storm_tpu's ``init_sharded_training``,
``pipeline_apply``) are not ported yet. Callers import the submodules.
"""
