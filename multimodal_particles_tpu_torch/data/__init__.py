"""Data of the port: the batch containers and synthetic batches
(`batches.py`), and the jet pipeline (`particle_clouds/`: readers, the
`ParticleClouds` container, `JetDataclass`, the observables and the
dataloader)."""

from multimodal_particles_tpu_torch.data.batches import (  # noqa: F401
    InMemoryDataModule,
    MultimodalDatabatch,
    absorbing_training_batch,
    gauss_noise_source_batch,
    multiplicity_histogram,
    synthetic_training_batch,
    transdim_training_batch,
)
