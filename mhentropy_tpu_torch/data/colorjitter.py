"""torchvision-ColorJitter-equivalent appearance augmentation (host side).

Port of mhentropy_tpu/data/colorjitter.py, line for line (hue through
Pillow, as there).

The reference's RHD training path applies
`torchvision.transforms.ColorJitter(brightness=0.8, contrast=[0.4,1.6],
saturation=[0.4,1.6], hue=0.1)` to the uint8 crop before ToTensor
(rhddataloader.py:153-155; HO3D inserts the same jitter only under the
non-default dpda='RHD', ho3d_dataloader.py:404-409). This module is that
transform without torchvision, matching the PIL backend's EXACT uint8
arithmetic (torchvision dispatches u8 PIL images to ImageEnhance /
convert):

  - brightness / contrast / saturation are PIL Image.blend interpolations,
    which TRUNCATE: out = clip(trunc(deg + f*(img - deg)), 0, 255)
    (verified against ImageEnhance on random images — round-half-up was
    off by one on 71/192 pixels, trunc is exact);
  - the contrast degenerate is the solid gray int(mean(L) + 0.5) and the
    saturation degenerate is the L image, with L the ITU-R 601-2 fixed
    point PIL uses: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16;
  - hue goes through PIL itself (convert("HSV"), shift H mod 256, convert
    back) — torchvision's F_pil.adjust_hue does exactly this, and PIL's
    HSV round-trip is lossy in a way only PIL reproduces.

Parameter semantics match ColorJitter.get_params: brightness=0.8 means
U(max(0, 1-0.8), 1+0.8); list params are used verbatim; hue=0.1 means
U(-0.1, 0.1); the four ops apply in a uniformly random order with all
four factors drawn up front (brightness, contrast, saturation, hue).

RNG: factors come from a dedicated per-item stream
(common.item_rng_stream) — the reference drew from torch's GLOBAL
generator inside DataLoader workers, which is schedule-dependent and
irreproducible, so there is no draw-order parity to keep. Because jitter is u8-in/u8-out
(exactly as the reference applies it before ToTensor), the uint8 device
transport stays value-exact with jitter on.
"""

from __future__ import annotations

import numpy as np

#: The reference's exact constructor arguments (rhddataloader.py:153).
REFERENCE_PARAMS = dict(
    brightness=0.8, contrast=(0.4, 1.6), saturation=(0.4, 1.6), hue=0.1)


def _lum(img_u8: np.ndarray) -> np.ndarray:
    """PIL convert('L'): ITU-R 601-2 in 16.16 fixed point with rounding."""
    r = img_u8[..., 0].astype(np.uint32)
    g = img_u8[..., 1].astype(np.uint32)
    b = img_u8[..., 2].astype(np.uint32)
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def _blend(img_u8: np.ndarray, degenerate, factor: float) -> np.ndarray:
    """PIL Image.blend(degenerate, img, factor): truncating interpolation."""
    out = degenerate + factor * (img_u8.astype(np.float64) - degenerate)
    return np.clip(np.trunc(out), 0, 255).astype(np.uint8)


def adjust_brightness(img_u8: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img_u8, 0.0, factor)


def adjust_contrast(img_u8: np.ndarray, factor: float) -> np.ndarray:
    # int(mean + 0.5) of the L image — ImageEnhance.Contrast's degenerate.
    mean = int(float(_lum(img_u8).mean()) + 0.5)
    return _blend(img_u8, float(mean), factor)


def adjust_saturation(img_u8: np.ndarray, factor: float) -> np.ndarray:
    deg = _lum(img_u8)[..., None].astype(np.float64)
    return _blend(img_u8, deg, factor)


def adjust_hue(img_u8: np.ndarray, factor: float) -> np.ndarray:
    """torchvision F_pil.adjust_hue verbatim: PIL HSV round trip with the
    H channel shifted by uint8(factor * 255) (wrapping)."""
    if not -0.5 <= factor <= 0.5:
        raise ValueError(f"hue factor {factor} not in [-0.5, 0.5]")
    from PIL import Image

    hsv = np.array(Image.fromarray(img_u8).convert("HSV"))
    shift = np.int16(int(factor * 255)) % 256  # C-style trunc + wrap
    hsv[..., 0] = ((hsv[..., 0].astype(np.int16) + shift) % 256).astype(
        np.uint8)
    return np.asarray(Image.fromarray(hsv, "HSV").convert("RGB"))


_OPS = (adjust_brightness, adjust_contrast, adjust_saturation, adjust_hue)


def sample_params(rng: np.random.RandomState,
                  brightness=0.8, contrast=(0.4, 1.6),
                  saturation=(0.4, 1.6), hue=0.1):
    """(order, factors) like ColorJitter.get_params: permutation first,
    then all four factors in fixed (b, c, s, h) order."""
    order = rng.permutation(4)
    if not isinstance(brightness, (tuple, list)):
        brightness = (max(0.0, 1.0 - brightness), 1.0 + brightness)
    if not isinstance(hue, (tuple, list)):
        hue = (-hue, hue)
    factors = (
        float(rng.uniform(*brightness)),
        float(rng.uniform(*contrast)),
        float(rng.uniform(*saturation)),
        float(rng.uniform(*hue)),
    )
    return order, factors


def color_jitter(rng: np.random.RandomState, img_u8: np.ndarray,
                 **params) -> np.ndarray:
    """Apply the reference jitter to a (H, W, 3) uint8 image. u8 in/out."""
    kw = dict(REFERENCE_PARAMS)
    kw.update(params)
    order, factors = sample_params(rng, **kw)
    out = np.ascontiguousarray(img_u8)
    for i in order:
        out = _OPS[i](out, factors[i])
    return out
