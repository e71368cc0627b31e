"""Dataset and dataloader of the jet particle clouds, the counterparts of
multimodal_particles_tpu/data/particle_clouds/jets_dataloader.py:32-293.

The batches are the port's: a `MultimodalDatabatch` of tensors ('namedtuple'
return type: MBM and the absorbing family) or the transdimensional family's
list [n_particles, target_continuous, target one-hot, ...] ('list'). The
dataset moves its preprocessed arrays to the given device once, and a batch
is a gather there. The batch order is the JAX package's: the same numpy
shuffle of the training indices each epoch and the same split, so that both
packages yield the same jets in the same batches.
"""

import numpy as np
import torch

from multimodal_particles_tpu_torch.data.batches import MultimodalDatabatch
from multimodal_particles_tpu_torch.data.particle_clouds.jets import JetDataclass
from multimodal_particles_tpu_torch.data.particle_clouds.utils import sizes_to_histograms


def _tensor_dtype(attr: str) -> torch.dtype:
    if attr.endswith("_discrete"):
        return torch.int64
    return torch.float32


class MultimodalBridgeDataset:
    """Array-backed dataset with the 'namedtuple' and 'list' return types
    (jets_dataloader.py:32-114). `arrays` holds the preprocessed numpy arrays
    by attribute, `tensors` the same on `device` (tokens int64, the rest
    float32; in 'list' mode the discrete attributes as float32 one-hots)."""

    def __init__(self, data: JetDataclass, return_type=None, *, device):
        self.data = data
        self.attributes = []
        self.vocab_size_features = data.vocab_size_features
        self.vocab_size_context = data.vocab_size_context
        self.return_type = return_type if return_type is not None else data.config.data.return_type
        if self.return_type not in ("namedtuple", "list"):
            raise ValueError("Invalid return_type. Choose 'namedtuple' or 'list'.")
        self.device = torch.device(device)
        self.arrays = {}

        def add(attr, value, listed=True):
            if listed:
                self.attributes.append(attr)
            self.arrays[attr] = value

        if self.return_type == "namedtuple":
            for name in ("continuous", "discrete", "mask"):
                if hasattr(data.source, name):
                    add(f"source_{name}", getattr(data.source, name))
        for name in ("continuous", "discrete"):
            if hasattr(data.target, name):
                add(f"target_{name}", getattr(data.target, name))
        if hasattr(data.target, "mask"):
            add("target_mask", data.target.mask, listed=self.return_type != "list")
        for name in ("context_continuous", "context_discrete"):
            if hasattr(data, name):
                add(name, getattr(data, name))

        self.tensors = {}
        for attr, value in self.arrays.items():
            dtype = _tensor_dtype(attr)
            if self.return_type == "list" and attr.endswith("_discrete"):
                vocab = (self.vocab_size_context if attr == "context_discrete"
                         else self.vocab_size_features)
                value, dtype = _one_hot(value[..., 0], vocab), torch.float32
            self.tensors[attr] = torch.as_tensor(np.asarray(value)).to(self.device, dtype)
        if self.return_type == "list":
            n = self.arrays["target_mask"][..., 0].sum(axis=-1)
            self.tensors["n_particles"] = torch.as_tensor(n).to(self.device, torch.int32)

    def __len__(self):
        return len(self.data.target)

    def gather(self, idx):
        """One batch for an array of integer indices."""
        idx = torch.as_tensor(np.asarray(idx), dtype=torch.long).to(self.device)
        if self.return_type == "namedtuple":
            return MultimodalDatabatch(**{
                attr: self.tensors[attr].index_select(0, idx) for attr in self.attributes})
        batch = [self.tensors["n_particles"].index_select(0, idx)]
        batch += [self.tensors[attr].index_select(0, idx) for attr in self.attributes]
        return batch

    def __getitem__(self, idx):
        if np.isscalar(idx):
            batch = self.gather(np.array([idx]))
            if self.return_type == "namedtuple":
                return MultimodalDatabatch(**{
                    attr: getattr(batch, attr)[0] for attr in self.attributes})
            return [v[0] for v in batch]
        return self.gather(np.asarray(idx))

    def get_available_keys(self):
        return self.attributes


def _one_hot(tokens, num_classes):
    return (tokens[..., None] == np.arange(num_classes)).astype(np.float32)


class _Loader:
    """Epoch iterator over a subset of the dataset (jets_dataloader.py:121-146):
    the training loader reshuffles its indices at every epoch with one numpy
    generator."""

    def __init__(self, dataset, indices, batch_size, shuffle, seed=0):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return (len(self.indices) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = self.indices.copy()
        if self.shuffle:
            self._rng.shuffle(idx)
        for start in range(0, len(idx), self.batch_size):
            yield self.dataset.gather(idx[start:start + self.batch_size])


class JetsDataloaderModule:
    """Train/validation/test split, the batch iterators and the multiplicity
    histograms (jets_dataloader.py:149-293), with batches on `device`."""

    def __init__(self, config, jetdataset, *, device):
        self.dataclass = jetdataset
        self.config = config
        self.device = torch.device(device)
        self.dataset = MultimodalBridgeDataset(
            jetdataset, return_type=config.data.return_type, device=self.device)

        self.histogram_target = sizes_to_histograms(
            self.dataset.arrays["target_mask"][..., 0].sum(axis=1))
        if config.data.return_type == "namedtuple":
            self.histogram_source = sizes_to_histograms(
                self.dataset.arrays["source_mask"][..., 0].sum(axis=1))

        self.data_split = config.data.data_split_frac
        self.batch_size = config.data.batch_size
        self.set_dataloader()

        # the transdimensional family's particle creation and destruction
        # reads the graphical structure (jets_dataloader.py:177-182)
        if hasattr(config.data, "graphical_structure"):
            self.set_batch_handlers()
            from multimodal_particles_tpu_torch.models.generative.transdimensional.structure import (
                JetsGraphicalStructure,
            )

            self.graphical_structure = JetsGraphicalStructure(self)

    def train_val_test_split(self):
        assert abs(1.0 - sum(self.data_split)) < 1e-3, "Split fractions do not sum to 1!"
        total = len(self.dataset)
        train_size = int(total * self.data_split[0])
        valid_size = int(total * self.data_split[1])
        idx = np.arange(total)
        if self.data_split[2] == 0:
            # flooring both fractions can strand a remainder in the unused
            # test slice: it goes to validation (jets_dataloader.py:194-197)
            return idx[:train_size], idx[train_size:], idx[:0]
        return (
            idx[:train_size],
            idx[train_size:train_size + valid_size],
            idx[train_size + valid_size:],
        )

    def set_dataloader(self):
        idx_train, idx_valid, idx_test = self.train_val_test_split()
        self.train = _Loader(self.dataset, idx_train, self.batch_size, shuffle=True)
        self.valid = (
            _Loader(self.dataset, idx_valid, self.batch_size, shuffle=False)
            if len(idx_valid) > 0 else None
        )
        self.test = (
            _Loader(self.dataset, idx_test, self.batch_size, shuffle=False)
            if self.data_split[2] > 0 and len(idx_test) > 0 else None
        )

    def update_config(self, model_config):
        model_config.data.target_info["hist_num_particles"] = self.histogram_target
        if self.config.data.return_type == "namedtuple":
            model_config.data.source_info["hist_num_particles"] = self.histogram_source
        return model_config

    # the transdimensional batch handlers' metadata (jets_dataloader.py:245-293)

    def set_without_onehot_shapes(self, names_in_batch):
        cfg = self.config
        N = cfg.data.max_num_particles
        shapes = []
        for name in names_in_batch:
            if name == "target_continuous":
                shapes.append((N, cfg.data.dim_features_continuous))
            if name == "target_mask":
                shapes.append((N, 1))
            if name == "context_continuous":
                shapes.append((N, cfg.data.dim_context_continuous))
            if name == "context_discrete":
                shapes.append((N, cfg.data.vocab_size_features))
        self.without_onehot_shapes = shapes

    def set_onehot_shapes(self, names_in_batch):
        cfg = self.config
        N = cfg.data.max_num_particles
        shapes = []
        for name in names_in_batch:
            if name == "target_continuous":
                shapes.append((N, cfg.data.dim_features_continuous))
            if name == "target_discrete":
                shapes.append((N, cfg.data.vocab_size_features))
            if name == "target_mask":
                shapes.append((N, 1))
            if name == "context_continuous":
                shapes.append((N, cfg.data.dim_context_continuous))
            if name == "context_discrete":
                shapes.append((N, cfg.data.vocab_size_features))
        self.with_onehot_shapes = shapes

    def set_batch_handlers(self):
        names_in_batch = self.dataset.get_available_keys()
        self.names_in_batch = names_in_batch
        self.observed = np.zeros(len(names_in_batch), dtype=int)
        self.is_onehot = np.zeros(len(names_in_batch), dtype=int)
        self.exist = np.ones(len(names_in_batch), dtype=int)
        self.name_to_index = dict(zip(names_in_batch, range(len(names_in_batch))))

        if "target_discrete" in names_in_batch:
            self.is_onehot[self.name_to_index["target_discrete"]] = 1
        if "context_continuous" in names_in_batch:
            self.observed[self.name_to_index["context_continuous"]] = 1
        if "context_discrete" in names_in_batch:
            self.observed[self.name_to_index["context_discrete"]] = 1

        self.set_onehot_shapes(names_in_batch)
        self.set_without_onehot_shapes(names_in_batch)
