"""Multi-file driving of the port: the checkpointed batch driver
(``batch.BatchDriver``). Multi-GPU meshes are not ported yet (ROADMAP.md
§A item 11)."""
