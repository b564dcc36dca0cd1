"""Distribution on ``torch.distributed``, the port's copy of
``repro.distributed``: SPMD ranks, one process per shard, on a ``Mesh``
of the port's own (``mesh.py``: the axes, the collectives, ``run_spmd``);
the lowering context (``ctx.py``), the sharding rules and slices
(``sharding.py``), elastic re-meshing (``elastic.py``), int8 gradient
all-reduce (``grad_compress.py``), weight streaming (``hybrid_stream.py``),
GPipe over ``pod`` (``pipeline.py``) and the atomic checkpoint store
(``checkpoint.py``) the trainer and the fleet router write."""
