"""Data and tensor parallelism on torch.distributed (the mesh, the
collectives, the Megatron pairing, the global-batch loss semantics) and the
bulk generation sweep (`bulk_sampling.py`)."""

from multimodal_particles_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    make_device_mesh,
    pad_to_multiple,
    replicated_sharding,
    shard_batch,
)
