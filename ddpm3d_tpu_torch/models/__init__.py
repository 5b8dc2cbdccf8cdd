"""The denoiser's modules: primitives, wiring plan, UNet and factories."""

from .unet import ResBlock, SuperResModel, UNetModel
