"""Patch grids, Hann blending, TIFF volume IO and the training data."""

from .dataset import PatchDataset, load_data, load_volume_pair, prefetch
