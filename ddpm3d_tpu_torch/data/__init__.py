"""Patch grids, Hann blending, TIFF volume IO and the training data."""

from . import tiff_io
from .dataset import (
    PatchDataset,
    WholeVolumeDataset,
    center_crop_arr,
    list_image_files_recursively,
    load_data,
    load_volume_pair,
    prefetch,
    random_crop_arr,
)
from .patches import (
    blend_patches_count,
    blend_patches_hann,
    extract_patches_zxy,
    hann_window_3d,
    patch_grid,
    test_xy_starts,
    test_z_starts,
    train_xy_starts,
    train_z_starts,
)
