"""Whole-volume denoising."""

from .pipeline import denoise_patches, denoise_volume, load_volume_for_denoising, save_outputs
