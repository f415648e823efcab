"""The mesh layer (port of dvc_tpu/parallel/): data, ZeRO and tensor
parallelism over torch.distributed, multi-process start-up, and the
frame-sharded (sequence-parallel) convolution and LSTM."""

from dvc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Replicate,
    Shard,
    data_sharding,
    make_mesh,
    param_sharding_for,
    replicated,
    shard_batch,
    train_state_shardings,
    zero_sharding_for,
)
