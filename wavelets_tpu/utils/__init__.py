from .noise_calibration import compute_noise_weights
from .io import save_coefficients, load_coefficients
from .frameio import FrameStack, write_array, native_available
from .profiling import (StageTimer, Cost, decompose_cost, wow_cost,
                        roofline, peak_for)
from .compile_cache import enable_compile_cache

__all__ = [
    "compute_noise_weights",
    "save_coefficients",
    "load_coefficients",
    "FrameStack",
    "write_array",
    "native_available",
    "StageTimer",
    "Cost",
    "decompose_cost",
    "wow_cost",
    "roofline",
    "peak_for",
    "enable_compile_cache",
    # watroo.utils module-path compatibility (lazy: avoids import cycles)
    "denoise",
    "wow",
    "richardson_lucy",
    "enhance",
    "prepare_params",
]

_WATROO_UTILS_COMPAT = {
    "denoise": ("wavelets_tpu.models.denoise", "denoise"),
    "wow": ("wavelets_tpu.models.wow", "wow"),
    "richardson_lucy": ("wavelets_tpu.models.richardson_lucy",
                        "richardson_lucy"),
    "enhance": ("wavelets_tpu.models.enhance", "enhance"),
    "prepare_params": ("wavelets_tpu.models.enhance", "prepare_params"),
}


def __getattr__(name):
    """``watroo.utils`` path parity: ``from wavelets_tpu.utils import
    wow`` works like the reference's ``from watroo.utils import wow``."""
    try:
        mod_name, attr = _WATROO_UTILS_COMPAT[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)
