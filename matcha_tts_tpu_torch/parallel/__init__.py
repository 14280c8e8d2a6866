"""Data parallelism over torch.distributed, one process per rank: meshes,
a rank's share of a batch, the collectives, and a launcher with a deadline."""

from matcha_tts_tpu_torch.parallel.mesh import (  # noqa: F401
    BatchRows,
    BatchSharding,
    batch_sharding,
    init_process,
    make_mesh,
    make_mesh_2d,
    make_multislice_mesh,
    replicate,
    shard_batch,
)
