"""Plain float64 reference of the watroo semantics, in numpy.

Written from the semantics and file:line citations in SURVEY.md §2-3
(reference: frederic-auchere/wavelets, ``watroo/wavelets.py`` and
``watroo/utils.py``).  It imports nothing from ``wavelets_tpu`` and
needs no watroo, OpenCV or numexpr: every array is float64 numpy, and
the only library call beyond numpy is ``scipy.special.erf``.  The golden
tests and ``chip_smoke.py`` compare the engine against it.

Straightforward by design: the 2-D dilated smoothing is computed as two
1-D passes, which equals the reference's full outer-product kernel with
edge-duplicated reflection on both axes (watroo/wavelets.py:39-45);
everything else follows the reference loop for loop.
"""

from __future__ import annotations

import itertools
import warnings

import numpy as np
from scipy.special import erf

__all__ = [
    "TAPS", "SIGMA_E", "sigma_e", "kernel_nd", "convolution",
    "sdev_loc", "atrous_convolution", "correlate2d", "transform",
    "transform_recursive", "Coefficients", "generalized_anscombe",
    "denoise", "wow", "prepare_params", "enhance", "richardson_lucy",
]

# ---- scaling functions (watroo/wavelets.py:232-287) ------------------

#: 1-D taps (watroo/wavelets.py:239, :268)
TAPS = {
    "triangle": (1 / 4, 1 / 2, 1 / 4),
    "b3spline": (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16),
}

#: σ_e tables keyed by (name, ndim, bilateral) — the expected std of each
#: detail plane of unit Gaussian noise (watroo/wavelets.py:241-254,
#: :270-283).  The 2-D bilateral B3spline table has 10 entries, one short
#: of the others (:280-281).
SIGMA_E = {
    ("triangle", 1, False): (
        0.60840933, 0.33000059, 0.21157957, 0.145824, 0.10158388,
        0.07155912, 0.04902655, 0.03529812, 0.02409187, 0.01722846,
        0.01144442),
    ("triangle", 2, False): (
        0.7999247, 0.27308452, 0.11998217, 0.05793947, 0.0288104,
        0.01447795, 0.00733832, 0.0037203, 0.00192882, 0.00098568,
        0.00048533),
    ("triangle", 3, False): (
        0.89736751, 0.19514386, 0.06239262, 0.02311278, 0.00939645),
    ("triangle", 2, True): (
        0.31063172, 0.34575647, 0.23712331, 0.13559906, 0.07172004,
        0.03665405, 0.01850046, 0.00928768, 0.00465967, 0.00234445,
        0.00119249),
    ("triangle", 3, True): (
        0.3828863, 0.36182913, 0.19520299, 0.08498861, 0.03363142),
    ("b3spline", 1, False): (
        0.72514976, 0.28538683, 0.17901161, 0.12222841, 0.08469601,
        0.06027006, 0.04242257, 0.02919823, 0.01805671, 0.01383672,
        0.00943623),
    ("b3spline", 2, False): (
        8.907e-01, 2.0072e-01, 8.5551e-02, 4.1261e-02, 2.0470e-02,
        1.0232e-02, 5.1435e-03, 2.6008e-03, 1.3161e-03, 6.7359e-04,
        4.0040e-04),
    ("b3spline", 3, False): (
        0.95633954, 0.12491933, 0.03933029, 0.01489642, 0.0064108),
    ("b3spline", 2, True): (
        0.38234752, 0.24305799, 0.16012153, 0.10633541, 0.07083733,
        0.04728659, 0.03163678, 0.02122341, 0.01429102, 0.00952376),
    ("b3spline", 3, True): (
        0.44111772, 0.3552894, 0.16137159, 0.05769064, 0.01932497),
}


def sigma_e(name, ndim, bilateral=False):
    """σ_e table (watroo/wavelets.py:199-219)."""
    return np.asarray(SIGMA_E[(name, ndim, bool(bilateral))])


def kernel_nd(name, ndim):
    """Dense n-D kernel by outer products (watroo/wavelets.py:170-189)."""
    t = np.asarray(TAPS[name], np.float64)
    k = t
    for _ in range(ndim - 1):
        k = np.multiply.outer(k, t)
    return k


# ---- convolution primitives (watroo/wavelets.py:24-105) --------------

def _mode(ndim):
    """Boundary per dimensionality (SURVEY §2.4): 2-D/3-D use cv2
    BORDER_REFLECT ≡ np.pad 'symmetric' (watroo/wavelets.py:39-64); 1-D
    uses scipy 'mirror' ≡ np.pad 'reflect' (:66-69)."""
    return "symmetric" if ndim in (2, 3) else "reflect"


def _smooth_axis(x, taps, s, axis, mode):
    hw = len(taps) // 2
    d = 2 ** s
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (hw * d, hw * d)
    xp = np.pad(x, pad, mode=mode)
    out = np.zeros_like(x)
    for j, t in enumerate(taps):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(j * d, j * d + n)
        out += t * xp[tuple(idx)]
    return out


def convolution(arr, name, s=0):
    """Dilated smoothing by the scaling function at scale ``s``
    (watroo/wavelets.py:35-71): separable over every axis, with the
    per-ndim boundary of :func:`_mode`."""
    x = np.asarray(arr, np.float64)
    out = x
    for axis in range(x.ndim):
        out = _smooth_axis(out, TAPS[name], s, axis, _mode(x.ndim))
    return out


def sdev_loc(image, name, s=0, variance=False):
    """Local std/variance ⟨x²⟩−⟨x⟩² with the ≤0 → 1e-20 clamp
    (watroo/wavelets.py:24-32)."""
    mean = convolution(image, name, s)
    vari = convolution(np.asarray(image, np.float64) ** 2, name, s) - mean ** 2
    vari[vari <= 0] = 1e-20
    return vari if variance else np.sqrt(vari)


def atrous_convolution(image, kernel, bilateral_variance=None, s=0,
                       mode="symmetric"):
    """Shift-and-accumulate à trous convolution and its bilateral variant
    (watroo/wavelets.py:74-105): pad ``hw·2^s`` per side, start from the
    centre tap, add every other tap's shifted copy; the bilateral range
    weight is ``k·exp(−(image−shifted)²/(2·variance))`` and the result is
    divided by the summed weights."""
    image = np.asarray(image, np.float64)
    kernel = np.asarray(kernel, np.float64)
    d = 2 ** s
    hws = [k // 2 for k in kernel.shape]
    padded = np.pad(image, [(h * d, h * d) for h in hws], mode=mode)
    centre = kernel[tuple(hws)]
    out = centre * image
    norm = np.full_like(image, centre)
    for idx in itertools.product(*[range(k) for k in kernel.shape]):
        if idx == tuple(hws):
            continue
        k = kernel[idx]
        sl = tuple(slice(i * d, i * d + n)
                   for i, n in zip(idx, image.shape))
        shifted = padded[sl]
        if bilateral_variance is None:
            out = out + k * shifted
        else:
            w = k * np.exp(-(image - shifted) ** 2
                           / (2 * bilateral_variance))
            norm = norm + w
            out = out + w * shifted
    if bilateral_variance is not None:
        out = out / norm
    return out


def correlate2d(x, kernel):
    """``cv2.filter2D`` correlation with BORDER_REFLECT and a centred
    anchor (watroo/utils.py:257, :286)."""
    x = np.asarray(x, np.float64)
    kernel = np.asarray(kernel, np.float64)
    ph, pw = kernel.shape
    top, left = ph // 2, pw // 2
    xp = np.pad(x, [(top, ph - 1 - top), (left, pw - 1 - left)],
                mode="symmetric")
    H, W = x.shape
    out = np.zeros_like(x)
    for i in range(ph):
        for j in range(pw):
            out += kernel[i, j] * xp[i:i + H, j:j + W]
    return out


# ---- transforms (watroo/wavelets.py:290-444) -------------------------

def _normalize_bilateral(bilateral, level):
    """Per-scale σ list (watroo/wavelets.py:349-352, :421-424)."""
    if bilateral is None:
        return None
    sig = list(bilateral) if isinstance(bilateral, (list, tuple)) else [
        bilateral] * (level + 1)
    if len(sig) <= level:
        sig.extend([1] * (level - len(sig) + 1))
    return sig


def transform(arr, level, name="b3spline", bilateral=None,
              bilateral_scaling=False):
    """Standard à trous transform (watroo/wavelets.py:408-444): plane
    ``s+1`` smooths plane ``s`` at dilation ``2^s`` (bilateral: range
    variance ``sdev_loc·σ_b[s]²``, ×(s+1) when scaled, :434-440), then
    ``plane[s] −= plane[s+1]``.  Returns the (level+1, ...) cube."""
    x = np.asarray(arr, np.float64)
    sig = _normalize_bilateral(bilateral, level)
    planes = [x]
    for s in range(level):
        c = planes[-1]
        if sig is None:
            nxt = convolution(c, name, s)
        else:
            var = sdev_loc(c, name, s, variance=True) * sig[s] ** 2
            if bilateral_scaling:
                var = var * (s + 1)
            nxt = atrous_convolution(c, kernel_nd(name, c.ndim),
                                     bilateral_variance=var, s=s)
        planes.append(nxt)
    for s in range(level):
        planes[s] = planes[s] - planes[s + 1]
    return np.stack(planes)


def transform_recursive(arr, level, name="b3spline"):
    """Recursive à trous transform (watroo/wavelets.py:330-406): pad
    once by ``hw·2^(level−1)`` with symmetric reflection (:394-395);
    scale ``s`` convolves each of the stride-``2^s`` decimated
    sub-arrays with the undilated kernel (its own borders, :371-390);
    differences (:402-403), then crop (:405-406)."""
    x = np.asarray(arr, np.float64)
    if level == 0:
        return x[None]
    pad = len(TAPS[name]) // 2 * 2 ** (level - 1)
    xp = np.pad(x, pad, mode="symmetric")
    planes = [xp]
    for s in range(level):
        c = planes[-1]
        nxt = np.empty_like(c)
        step = 2 ** s
        for offs in itertools.product(range(step), repeat=x.ndim):
            sl = tuple(slice(o, None, step) for o in offs)
            nxt[sl] = convolution(c[sl], name, 0)
        planes.append(nxt)
    for s in range(level):
        planes[s] = planes[s] - planes[s + 1]
    crop = (slice(None),) + tuple(slice(pad, pad + n) for n in x.shape)
    return np.stack(planes)[crop]


class Coefficients:
    """Coefficient cube plus noise statistics
    (watroo/wavelets.py:108-149)."""

    def __init__(self, planes, name="b3spline", bilateral=None):
        self.data = np.asarray(planes, np.float64)
        self.name = name
        self.bilateral = bilateral
        self.noise = None

    def __len__(self):
        return len(self.data)

    @property
    def sigma_e(self):
        return sigma_e(self.name, self.data.ndim - 1,
                       self.bilateral is not None)

    def get_noise(self):
        """MAD estimator ``median(|w0|)/0.6745/σ_e[0]`` (:126-127)."""
        return np.median(np.abs(self.data[0])) / 0.6745 / self.sigma_e[0]

    def significance(self, sigma, scale, soft_threshold=True):
        """``erf(|w|/t)`` (soft) or ``|w| > t`` (hard) with
        ``t = sigma·noise·σ_e[scale]``; ones for ``sigma == 0`` or
        ``noise == 0`` (:129-143)."""
        if sigma == 0:
            return np.ones_like(self.data[0])
        if self.noise is None:
            self.noise = self.get_noise()
        if np.ndim(self.noise) == 0 and self.noise == 0:
            return np.ones_like(self.data[0])
        t = sigma * self.noise * self.sigma_e[scale]
        w = self.data[scale]
        if soft_threshold:
            return erf(np.abs(w / t))
        return (np.abs(w) > t).astype(np.float64)

    def denoise(self, sigma, weights=None, soft_threshold=True):
        """``w_s *= weight_s · significance(sigma_s, s)`` over
        ``zip(sigma, weights)`` (:145-149)."""
        if weights is None:
            weights = [1] * len(sigma)
        for s, (sg, wt) in enumerate(zip(sigma, weights)):
            self.data[s] = self.data[s] * (
                wt * self.significance(sg, s, soft_threshold))


# ---- applications (watroo/wavelets.py:14-21, watroo/utils.py) --------

def generalized_anscombe(signal, alpha=1.0, g=0.0, sigma=0.0,
                         inverse=False):
    """Generalized Anscombe transform and its algebraic inverse, with the
    ≤0 → 0 clamp on the forward branch (watroo/wavelets.py:14-21)."""
    x = np.asarray(signal, np.float64)
    if inverse:
        return ((alpha * x / 2) ** 2 + alpha * g - sigma ** 2
                - 3 * alpha / 8) / alpha
    dum = alpha * x + 3 * alpha ** 2 / 8 + sigma ** 2 - alpha * g
    dum = np.where(dum <= 0, 0.0, dum)
    return 2 * np.sqrt(dum) / alpha


def denoise(data, weights, name="b3spline", noise=None, bilateral=None,
            soft_threshold=True, anscombe=False):
    """Transform to ``len(weights)`` scales, threshold every detail plane
    at its σ multiple, sum the planes (watroo/utils.py:83-102)."""
    x = np.asarray(data, np.float64)
    if anscombe:
        x = generalized_anscombe(x)
    c = Coefficients(transform(x, len(weights), name, bilateral), name,
                     bilateral)
    c.noise = noise
    c.denoise(weights, soft_threshold=soft_threshold)
    out = c.data.sum(axis=0)
    if anscombe:
        out = generalized_anscombe(out, inverse=True)
    return out


def wow(data, name="b3spline", n_scales=None, weights=(), whitening=True,
        denoise_coefficients=(), noise=None, bilateral=None,
        bilateral_scaling=False, soft_threshold=True,
        preserve_variance=False, gamma=3.2, gamma_min=None,
        gamma_max=None, h=0):
    """Wavelets Optimized Whitening (watroo/utils.py:105-219).  ``data``
    is an image or a :class:`Coefficients` (reuse entry, :128-133).
    Returns ``(recon, whitened Coefficients)``."""
    if isinstance(data, Coefficients):
        coeffs = Coefficients(data.data.copy(), data.name, data.bilateral)
        coeffs.noise = data.noise if noise is None else noise
        name = data.name
        n_scales = len(data) - 1
        bilateral = data.bilateral
        ndim = data.data.ndim - 1
        auto = False
    else:
        x = np.asarray(data, np.float64)
        ndim = x.ndim
        auto = True
    dc = list(denoise_coefficients)
    if auto:
        # auto scale count and clamp (:122-127)
        max_scales = int(np.round(np.log2(min(x.shape))
                                  - np.log2(len(TAPS[name]))))
        if n_scales is None:
            n_scales = max_scales if h < 1 else len(dc)
        elif n_scales > max_scales:
            n_scales = max_scales
    table = sigma_e(name, ndim, bilateral is not None)
    if len(dc) >= len(table):
        # clamp to the σ_e table with a warning (:135-138)
        warnings.warn("Required number of scales larger than the maximum "
                      f"for scaling function. Using {len(table)}.")
        n_scales = len(table)
    if auto:
        coeffs = Coefficients(
            transform(x, n_scales, name, bilateral, bilateral_scaling),
            name, bilateral)
        coeffs.noise = noise
    # list padding (:160-170)
    w = list(weights)
    if len(w) <= n_scales:
        w.extend([1] * (n_scales - len(w) + 1))
    if len(dc) < n_scales:
        dc.extend([0] * (n_scales - len(dc)))
    if len(dc) == n_scales:
        dc.append(1)

    planes = coeffs.data
    if coeffs.noise is None and any(d != 0 for d in dc[:n_scales]):
        # the MAD noise reads the finest plane before any whitening
        coeffs.noise = coeffs.get_noise()
    gamma_scaled = np.zeros_like(planes[0]) if h > 0 else None
    for s in range(n_scales + 1):
        c = planes[s]
        power = c * c
        if preserve_variance:
            # :178-184
            power_norm = (np.std(c) if s == n_scales
                          else np.sqrt(np.mean(power)))
        else:
            power_norm = 1.0
        if s == n_scales:
            # residual: global std, clamped (:185-191)
            local_power = 1.0
            if whitening and h < 1:
                local_power = np.std(c)
                if local_power <= 0:
                    local_power = 1e-15
        else:
            # detail: smoothed local power (:193-199)
            local_power = 1.0
            if whitening and h < 1:
                lp = convolution(power, name, s)
                lp[lp <= 0] = 1e-15
                local_power = np.sqrt(lp)
            if dc[s] != 0:
                c = c * coeffs.significance(dc[s], s, soft_threshold)
        if h > 0:
            gamma_scaled = gamma_scaled + c
        planes[s] = c * (w[s] * power_norm / local_power)
    recon = planes.sum(axis=0)
    if h > 0:
        # gamma blend (:205-217)
        gmin = np.min(gamma_scaled) if gamma_min is None else gamma_min
        gmax = np.max(gamma_scaled) if gamma_max is None else gamma_max
        gs = np.clip((gamma_scaled - gmin) / (gmax - gmin), 0, 1)
        recon = (1 - h) * recon + h * gs ** (1 / gamma)
    return recon, coeffs


def prepare_params(param, ndims):
    """Per-channel parameter normalization (watroo/utils.py:10-33)."""
    if ndims == 2:
        if param is None:
            return []
        return list(param) if isinstance(param, list) else [param]
    if not isinstance(param, list):
        return [prepare_params(param, 2) for _ in range(ndims)]
    if len(param) != ndims:
        raise ValueError("Invalid number of parameters")
    return [prepare_params(p, 2) for p in param]


def enhance(*args, weights=None, denoise=None, soft_threshold=True,
            name="b3spline"):
    """Per-channel denoise + weighting (watroo/utils.py:36-80); 3-D input
    holds channels on axis 0, ``args[1]`` an optional noise level (per
    channel for 3-D)."""
    img = np.asarray(args[0], np.float64)
    noise = args[1] if len(args) == 2 else None
    weights = prepare_params(weights, img.ndim)
    dns = prepare_params(denoise, img.ndim)

    def one(channel, wgt, dn, nz):
        wgt = list(wgt) + [1] * (len(dn) - len(wgt))
        dn = list(dn) + [0] * (len(wgt) - len(dn))
        c = Coefficients(transform(channel, len(wgt), name), name)
        c.noise = c.get_noise() if nz is None else nz
        c.denoise(dn, weights=wgt, soft_threshold=soft_threshold)
        return c.data.sum(axis=0)

    if img.ndim == 3:
        return np.stack([
            one(img[c], weights[c], dns[c],
                None if noise is None else noise[c]) for c in range(3)])
    return one(img, weights, dns, noise)


def richardson_lucy(data, psf, iterations=10,
                    denoise_coefficients=(5, 2, 1), threshold_type="soft",
                    uniform_init=False, persistent_mrs=True, fft=False,
                    name="b3spline"):
    """Richardson-Lucy deconvolution with a multiresolution support
    (watroo/utils.py:222-290)."""
    x = np.asarray(data, np.float64)
    psf = np.asarray(psf, np.float64)
    level = len(denoise_coefficients)
    soft = threshold_type == "soft"
    init = Coefficients(transform(x, level, name), name)
    if uniform_init:
        # :232-234 — the support's noise is re-estimated every iteration
        psi = np.full_like(x, np.mean(x))
        noise = None
    else:
        init.denoise(denoise_coefficients, soft_threshold=soft)
        psi = init.data.sum(axis=0)
        noise = init.noise
    mrs = (np.ones if soft else np.zeros)((level,) + x.shape)
    if fft:
        # centred, rolled PSF spectrum (:245-250)
        H, W = x.shape
        ph, pw = psf.shape
        padded = np.zeros(x.shape)
        padded[H // 2 - ph // 2:H // 2 - ph // 2 + ph,
               W // 2 - pw // 2:W // 2 - pw // 2 + pw] = psf
        spec = np.fft.rfft2(np.roll(padded, (H // 2, W // 2), axis=(0, 1)))
    for it in range(iterations):
        if fft:
            phi = np.fft.irfft2(np.fft.rfft2(psi) * spec, s=x.shape)
        else:
            phi = correlate2d(psi, psf[::-1, ::-1])
        res = Coefficients(transform(x - phi, level, name), name)
        res.noise = noise
        for s in range(level):
            sig = res.significance(denoise_coefficients[s], s, soft)
            if soft:
                # multiplicative support, decaying exponent (:272-276)
                m = mrs[s] * sig if persistent_mrs else sig
                res.data[s] = res.data[s] * m ** (1 / (it + 1))
            else:
                # sticky support (:266-270)
                m = np.maximum(mrs[s], sig) if persistent_mrs else sig
                res.data[s] = res.data[s] * m
            mrs[s] = m
        r = (res.data.sum(axis=0) + phi) / phi
        if fft:
            conv = np.fft.irfft2(np.fft.rfft2(r) * spec.conj(), s=x.shape)
        else:
            conv = correlate2d(r, psf)
        psi = psi * conv
    return psi
