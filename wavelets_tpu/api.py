"""watroo-compatible object façade over the functional core.

A user of the reference package should be able to switch imports and keep
their code: ``AtrousTransform``, ``B3spline``/``Triangle`` (classes
instantiated with ``n_dim``), ``Coefficients`` (with ``__array__``/
``__len__``/``get_noise``/``significance``/``denoise``), and the
free functions ``convolution`` / ``atrous_convolution`` / ``sdev_loc``.

This layer is deliberately thin: all compute dispatches to the jitted
functional core (``wavelets_tpu.core`` / ``wavelets_tpu.ops``); arrays
stay on device (outputs are ``jax.Array``; ``np.asarray`` works via the
buffer protocol for interop, matching the reference's numpy idioms).

Reference surface: ``watroo/wavelets.py:108-149`` (Coefficients),
``:152-287`` (scaling functions), ``:290-444`` (AtrousTransform).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .core.transform import decompose, normalize_bilateral, synthesize
from .ops import conv as _conv
from .ops import stats as _stats
from .ops.filters import B3SPLINE, TRIANGLE, ScalingFunction

__all__ = [
    "AbstractScalingFunction",
    "Triangle",
    "B3spline",
    "Coefficients",
    "AtrousTransform",
    "convolution",
    "atrous_convolution",
    "sdev_loc",
]


# Input dtypes the reference recasts to float64 (watroo/wavelets.py:297).
_RECASTING_TYPES = [np.int32, np.int64, ">f4", ">f8", "int16", "uint16",
                    "int32", "uint32"]


def _wide_float():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _as_device_array(arr):
    """numpy/jax → jax array, applying the reference dtype recast rules
    (watroo/wavelets.py:319-320): listed int / big-endian dtypes become the
    widest available float (f64 under x64, else f32)."""
    if isinstance(arr, jax.Array):
        if arr.dtype in (jnp.int16, jnp.int32, jnp.int64, jnp.uint16,
                         jnp.uint32):
            return arr.astype(_wide_float())
        return arr
    arr = np.asarray(arr)
    if arr.dtype in _RECASTING_TYPES:
        arr = arr.astype(np.float64)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return jnp.asarray(arr)


class AbstractScalingFunction:
    """Class-style scaling function, instantiated per-``n_dim`` exactly like
    the reference (watroo/wavelets.py:152-229).  Backed by a frozen
    :class:`~wavelets_tpu.ops.filters.ScalingFunction` spec."""

    _spec: ScalingFunction = None  # set by subclasses

    def __init__(self, n_dim: int):
        if self._spec is None:
            raise TypeError("AbstractScalingFunction is abstract")
        if n_dim not in (1, 2, 3):
            raise ValueError("Unsupported number of dimensions")
        self.name = self._spec.name
        self.n_dim = n_dim
        self.kernel = self._spec.kernel_nd(n_dim)

    # -- class-level data parity --------------------------------------
    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        spec = cls._spec
        if spec is not None:
            cls.coefficients_1d = np.asarray(spec.taps)
            for nd in (1, 2, 3):
                for bil, suffix in ((False, ""), (True, "_bilateral")):
                    t = spec.sigma_e(nd, bil)
                    setattr(cls, f"sigma_e_{nd}d{suffix}", t)

    @property
    def spec(self) -> ScalingFunction:
        return self._spec

    @property
    def coefficients_2d(self):
        return self._spec.kernel_nd(2)

    @property
    def coefficients_3d(self):
        return self._spec.kernel_nd(3)

    def make_kernel(self):
        return self._spec.kernel_nd(self.n_dim)

    def atrous_kernel(self, scale: int):
        """Dense dilated kernel (watroo/wavelets.py:191-197) — compat only;
        the engine never materializes the holes."""
        return self._spec.atrous_kernel_nd(self.n_dim, scale)

    def sigma_e(self, bilateral=None):
        return self._spec.sigma_e(self.n_dim, bilateral is not None)

    def compute_noise_weights(self, n_scales, n_trials=100, bilateral=None,
                              seed=0):
        """On-device Monte-Carlo regeneration of the σ_e tables
        (watroo/wavelets.py:221-229) — vmapped over trials."""
        from .utils.noise_calibration import compute_noise_weights

        return compute_noise_weights(
            self._spec, self.n_dim, n_scales, n_trials=n_trials,
            bilateral=bilateral, seed=seed,
        )


class Triangle(AbstractScalingFunction):
    """Triangle scaling function, taps [1/4, 1/2, 1/4]
    (watroo/wavelets.py:232-258)."""

    _spec = TRIANGLE


class B3spline(AbstractScalingFunction):
    """B3-spline scaling function, taps [1/16, 1/4, 3/8, 1/4, 1/16]
    (watroo/wavelets.py:261-287).  The default everywhere."""

    _spec = B3SPLINE


def _spec_of(scaling_function) -> ScalingFunction:
    """Accept a ScalingFunction spec, a compat class, or a compat instance."""
    if isinstance(scaling_function, ScalingFunction):
        return scaling_function
    if isinstance(scaling_function, AbstractScalingFunction):
        return scaling_function.spec
    if isinstance(scaling_function, type) and issubclass(
        scaling_function, AbstractScalingFunction
    ):
        return scaling_function._spec
    raise TypeError(f"Not a scaling function: {scaling_function!r}")


def _warn_output_ignored(output, fn_name):
    if output is not None:
        import warnings

        warnings.warn(
            f"{fn_name}(output=...) is accepted for signature parity but "
            "IGNORED: the engine is functional, the supplied buffer is "
            "never filled (the reference writes the result into it, "
            "watroo/wavelets.py:57-64).  Use the return value.",
            stacklevel=3)


def convolution(arr, scaling_function, s=0, output=None):
    """Dense separable dilated smoothing ≡ reference ``convolution``
    (watroo/wavelets.py:35-71), with per-ndim boundary conventions.

    .. warning:: ``output`` is accepted for signature parity but
       **ignored** — unlike the reference, the supplied buffer is never
       filled (functional semantics); a caller relying on the filled
       out-param would read a stale array, so passing one emits a
       ``UserWarning``.  Use the return value."""
    _warn_output_ignored(output, "convolution")
    arr = _as_device_array(arr)
    spec = _spec_of(scaling_function)
    return _conv.smooth(arr, spec, scale=s)


def sdev_loc(image, scaling_function, s=0, variance=False):
    """Local std/variance under the scaling window
    (watroo/wavelets.py:24-32)."""
    image = _as_device_array(image)
    spec = _spec_of(scaling_function)
    return _conv.sdev_loc(image, spec, scale=s, variance=variance)


def atrous_convolution(image, kernel, bilateral_variance=None, s=0,
                       mode="symmetric", output=None):
    """Generic n-D à trous convolution + bilateral variant
    (watroo/wavelets.py:74-105).  ``kernel`` is the dense *undilated*
    kernel (numpy).  ``output`` is ignored with a ``UserWarning`` — see
    :func:`convolution`."""
    _warn_output_ignored(output, "atrous_convolution")
    image = _as_device_array(image)
    if bilateral_variance is not None:
        bilateral_variance = _as_device_array(bilateral_variance)
    return _conv.atrous_conv_nd(
        image, np.asarray(kernel), scale=s,
        bilateral_variance=bilateral_variance, boundary=mode,
    )


class Coefficients:
    """À trous coefficient cube + statistics (watroo/wavelets.py:108-149).

    ``data`` is a ``(level+1, *shape)`` device array; ``np.sum(coeffs,
    axis=0)`` synthesis works through ``__array__``.  Unlike the reference
    the underlying array is immutable — ``denoise`` rebinds ``self.data``
    instead of mutating in place, and the reference idiom
    ``coeffs.data[s] *= mask`` raises (JAX arrays are immutable); write
    ``coeffs[s] = coeffs[s] * mask`` (see ``__setitem__``) instead.

    Construction also accepts the planes as a tuple/list of per-scale
    arrays (the ``planes_layout="rows"`` form ``wow`` emits, which
    defers the cube concatenation): the stacked cube is assembled lazily on first ``.data``
    access, while ``__len__``/``get_noise``/``significance`` read the
    individual planes without triggering assembly."""

    def __init__(self, data, scaling_function, bilateral=None):
        if isinstance(data, (tuple, list)) and all(
            isinstance(r, (jax.Array, np.ndarray)) for r in data
        ):
            # per-scale rows form; coerce numpy rows so every later
            # access (.data, get_noise, significance) sees arrays
            self._rows = tuple(
                r if isinstance(r, jax.Array) else jnp.asarray(r)
                for r in data)
            self._cube = None
        else:
            # anything else (incl. nested Python lists) is a cube
            self._rows = None
            self._cube = (data if isinstance(data, jax.Array)
                          else jnp.asarray(data))
        self.scaling_function = scaling_function
        self.bilateral = bilateral
        self.noise = None

    @property
    def data(self):
        if self._cube is None:
            self._cube = jnp.stack(self._rows)
            self._rows = None
        return self._cube

    @data.setter
    def data(self, value):
        self._cube = (value if isinstance(value, jax.Array)
                      else jnp.asarray(value))
        self._rows = None

    def _plane(self, s):
        return self._rows[s] if self._rows is not None else self.data[s]

    def __len__(self):
        return (len(self._rows) if self._rows is not None
                else len(self.data))

    def __getitem__(self, s):
        """Plane access: ``coeffs[s]`` ≡ ``coeffs.data[s]`` without
        forcing the lazy cube assembly."""
        if isinstance(s, (int, np.integer)) and self._rows is not None:
            return self._rows[s]
        return self.data[s]

    def __setitem__(self, s, value):
        """Functional substitute for the reference's in-place plane
        mutation idiom ``coeffs.data[s] *= mask``
        (watroo/wavelets.py:145-149).  JAX arrays are immutable, so
        ``coeffs.data[s] *= mask`` raises; write
        ``coeffs[s] = coeffs[s] * mask`` (or use
        ``coeffs.data.at[s].multiply(mask)`` and rebind) instead."""
        if self._rows is not None and isinstance(s, (int, np.integer)):
            rows = list(self._rows)
            rows[s] = jnp.asarray(value)
            self._rows = tuple(rows)
            return
        self.data = self.data.at[s].set(jnp.asarray(value))

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self.data)
        if dtype is not None:
            out = out.astype(dtype)
        return out

    @property
    def sigma_e(self):
        return self.scaling_function.sigma_e(bilateral=self.bilateral)

    def get_noise(self):
        """MAD noise from the finest plane (watroo/wavelets.py:126-127)."""
        return _stats.mad_noise(self._plane(0), float(self.sigma_e[0]))

    def significance(self, sigma, scale, soft_threshold=True):
        """Per-plane significance mask (watroo/wavelets.py:129-143)."""
        if sigma != 0:
            if self.noise is None:
                self.noise = self.get_noise()
            noise = self.noise
            if not isinstance(noise, (np.ndarray, jax.Array)) or (
                getattr(noise, "ndim", 1) == 0
            ):
                if float(noise) == 0:
                    return jnp.ones_like(self._plane(0))
            return _stats.significance(
                self._plane(scale), sigma, jnp.asarray(noise),
                float(self.sigma_e[scale]), soft_threshold,
            )
        return jnp.ones_like(self._plane(0))

    def denoise(self, sigma, weights=None, soft_threshold=True):
        """Scale-wise thresholding (watroo/wavelets.py:145-149); rebinds
        ``self.data``.  ``zip`` truncation semantics preserved — the
        residual plane is untouched when ``len(sigma) == level``."""
        sigma = tuple(sigma)
        if weights is None:
            weights = (1,) * len(sigma)
        if any(s != 0 for s in sigma) and self.noise is None:
            self.noise = self.get_noise()
        noise = self.noise if self.noise is not None else 0.0
        self.data = _stats.apply_denoise(
            self.data, sigma, tuple(weights),
            tuple(float(v) for v in self.sigma_e[: len(sigma)]),
            jnp.asarray(noise), soft_threshold,
        )


class AtrousTransform:
    """À trous transform engine (watroo/wavelets.py:290-328).

    ``transform = AtrousTransform(B3spline); coeffs = transform(img, n)``
    compiles (once per shape/level) and runs the whole decomposition as a
    single XLA program on device.
    """

    def __init__(self, scaling_function_class=B3spline, bilateral=None,
                 bilateral_scaling=False):
        self.scaling_function_class = scaling_function_class
        self.bilateral = bilateral
        self.bilateral_scaling = bilateral_scaling

    def __call__(self, arr, level, recursive=False):
        """Decompose ``arr`` over ``level`` scales → ``Coefficients`` with
        ``level+1`` planes.  ``recursive=True`` reproduces the reference
        recursive algorithm's output contract (identical interior, one-shot
        symmetric border padding); it runs the same standard engine —
        the decimated recursion is a CPU cache trick with no use on an
        accelerator."""
        arr = _as_device_array(arr)
        if arr.ndim > 3:
            raise ValueError("Unsupported number of dimensions")
        sf_compat = self.scaling_function_class(arr.ndim)
        spec = sf_compat.spec
        bilateral = normalize_bilateral(self.bilateral, level)
        planes = decompose(
            arr, level, spec,
            bilateral=bilateral,
            bilateral_scaling=self.bilateral_scaling,
            recursive_borders=bool(recursive),
        )
        return Coefficients(planes, sf_compat, self.bilateral)

    # Parity aliases for the reference's method names
    # (watroo/wavelets.py:330, :408).
    def atrous_standard(self, arr, level, scaling_function=None):
        return np.asarray(self(arr, level, recursive=False).data)

    def atrous_recursive(self, arr, level, scaling_function=None):
        return np.asarray(self(arr, level, recursive=True).data)
