"""Write the bundled `.h5` jet shards as `.npz` files that numpy alone reads.

    python scripts/shards_to_npz.py [SHARD.h5 ...]

With no argument, converts tests/resources/data/2016H_job0_mini.h5 and
jetclass_mini.h5. Each dataset is written unchanged (same name, dtype and
shape) and each attribute of the file as an `attr.<name>` entry, beside the
`.h5` with the suffix `.npz`. The PyTorch port's readers
(multimodal_particles_tpu_torch/data/particle_clouds/utils.py::read_shard)
read either file; a machine without h5py reads the `.npz`. Needs h5py.
"""

import os
import sys

import h5py
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = [os.path.join(ROOT, "tests", "resources", "data", name)
           for name in ("2016H_job0_mini.h5", "jetclass_mini.h5")]
ATTR_PREFIX = "attr."


def convert(h5_path: str) -> str:
    out = os.path.splitext(h5_path)[0] + ".npz"
    with h5py.File(h5_path, "r") as f:
        entries = {name: f[name][()] for name in f}
        entries.update({ATTR_PREFIX + k: np.asarray(v) for k, v in f.attrs.items()})
    np.savez_compressed(out, **entries)
    return out


if __name__ == "__main__":
    for path in sys.argv[1:] or DEFAULT:
        out = convert(path)
        print(f"{path} -> {out} ({os.path.getsize(out)} bytes)")
