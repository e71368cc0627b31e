"""Abstract bases of transdimensional datasets and graphical structures and
`gridify_images`; the port's copy of
multimodal_particles_tpu/data/transdimensional_base.py:1-58 (reference:
data/transdimensional_base.py:1-76). The wandb hook runs only where wandb is
installed and a run is active."""

import numpy as np


class StructuredDatasetBase:
    has_observations = False
    is_graphical_structure = False

    def get_data_dim(self):
        raise NotImplementedError

    def log_batch(self, tuple_of_tensors, log_name="examples"):
        """Optional experiment-tracker visualization hook; wandb is not a
        hard dependency (reference logs a wandb.Table at :29-46)."""
        try:  # pragma: no cover
            import wandb

            if wandb.run is not None:
                columns, data = self.get_wandb_table(tuple_of_tensors)
                wandb.log({log_name: wandb.Table(columns=columns, data=data)})
        except ImportError:
            pass


class GraphicalStructureBase:
    def shapes_without_onehot(self):
        raise NotImplementedError

    def shapes_with_onehot(self):
        return self.shapes_without_onehot()

    def remove_problem_dims(self, data, new_dims):
        raise NotImplementedError

    def adjust_st_batch(self, st_batch):
        return None

    def get_auto_target(self, st_batch, adjust_val):
        raise NotImplementedError

    def get_nearest_atom(self, st_batch, delxt_st_batch):
        raise NotImplementedError


def gridify_images(images):
    """Stack a list of (C, H, W) images into a rough square grid
    (reference: transdimensional_base.py:64-76)."""
    num = len(images)
    rows = int(np.floor(np.sqrt(num)))
    cols = int(np.ceil(num / rows))
    c, h, w = images[0].shape
    grid = np.zeros((c, rows * h, cols * w), dtype=images[0].dtype)
    for i, img in enumerate(images):
        r, col = divmod(i, cols)
        grid[:, r * h : (r + 1) * h, col * w : (col + 1) * w] = img
    return grid
