"""Data-parallel training over processes, as ``mas_tpu/parallel/`` over a
``data`` mesh axis: the rank bootstrap (``distributed``), the per-rank
batch (``mesh``) and the collectives the train steps call
(``collectives``)."""
