"""Data- and tensor-parallel training over processes, as
``mas_tpu/parallel/`` over a (``data``, ``model``) mesh: the rank
bootstrap and grid (``distributed``), the per-rank batch (``mesh``), the
transformer's shard layout (``sharding``) and the collectives the models
and train steps call (``collectives``)."""
