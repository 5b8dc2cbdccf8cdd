"""Patch grids, Hann blending and TIFF volume IO."""
