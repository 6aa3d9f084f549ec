"""wavelets_tpu — an accelerator-native à trous (undecimated) wavelet engine.

A from-scratch JAX/XLA framework with the capabilities of the
``watroo`` reference package (frederic-auchere/wavelets): dyadic à trous
decomposition with Triangle / B3-spline scaling functions, coefficient
significance statistics, soft/hard-threshold denoising, the WOW
(Wavelets Optimized Whitening) pipeline including the bilateral variant,
and multiresolution-supported Richardson-Lucy deconvolution — all
expressed as pure, jit-compiled functions that XLA compiles for the GPU,
and for SPMD execution over device meshes.

Public API parity with the reference (``watroo/__init__.py:1-4``):
``AtrousTransform``, ``B3spline``, ``Triangle``, ``Coefficients``,
``generalized_anscombe``, ``convolution``, ``denoise``, ``wow``,
``richardson_lucy``.
"""

from .version import __version__

from .ops.filters import ScalingFunction, TRIANGLE, B3SPLINE
from .ops.stats import generalized_anscombe
from .api import (
    AbstractScalingFunction,
    AtrousTransform,
    B3spline,
    Coefficients,
    Triangle,
    atrous_convolution,
    convolution,
    sdev_loc,
)
from .models.denoise import denoise
from .models.enhance import enhance, prepare_params
from .models.wow import wow, wow_stack
from .models.richardson_lucy import (richardson_lucy,
                                     richardson_lucy_stack)

__all__ = [
    # watroo-parity surface (watroo/wavelets.py:11 + watroo/utils.py:7)
    "AtrousTransform",
    "B3spline",
    "Triangle",
    "Coefficients",
    "generalized_anscombe",
    "convolution",
    "denoise",
    "wow",
    "wow_stack",
    "richardson_lucy",
    "richardson_lucy_stack",
    # documented-but-unexported reference helpers (watroo/utils.py:36, :10)
    "enhance",
    "prepare_params",
    "atrous_convolution",
    "sdev_loc",
    "AbstractScalingFunction",
    # native functional layer
    "ScalingFunction",
    "TRIANGLE",
    "B3SPLINE",
    "__version__",
]
