"""Multi-device execution over ``torch.distributed`` (port of
``nnpops_tpu.parallel``): ``sharding`` (the mesh, DP x EP training, TP,
PP, the atom-sharded energy), ``window_shard`` (the window pipeline
sharded over cell and row blocks), ``collectives`` (the collectives with
``shard_map``'s gradients) and ``launch`` (starting the ranks)."""
