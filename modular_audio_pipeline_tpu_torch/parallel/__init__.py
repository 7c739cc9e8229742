"""Multi-card and multi-file driving of the port: the device mesh
(``mesh``: one process per card under ``torchrun``, ``data`` and ``model``
axes), Whisper's Megatron tensor parallelism over the ``model`` axis
(``sharding``) and the checkpointed batch driver (``batch.BatchDriver``)."""
