"""Parallelism of the port, the counterpart of ``storm_tpu/parallel/``:
a mesh of ranks (``mesh``) and the collectives over its axes
(``collectives``); the placement of a batch and of parameters
(``sharding``: data parallelism, Megatron tensor parallelism); ring
attention and sequence-parallel encoder blocks (``ring_attention``,
``sequence``); the mixture-of-experts layer, at one expert shard or with
its experts split over ranks (``moe``); spawning a world of rank
processes (``launch``); the training step on one device and its dp x tp
sharding over a mesh (``train``: ``make_train_step``,
``init_sharded_training``, ``train_one_step``); and GPipe pipeline
parallelism over a stage axis (``pipeline``: ``pipeline_apply``,
``init_pp_training``). Callers import the submodules.
"""
