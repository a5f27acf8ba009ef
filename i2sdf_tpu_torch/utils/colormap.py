"""Colormaps on numpy arrays (the port's counterpart of the OpenCV
colormaps the JAX package's artifact writers take, `cv2.applyColorMap`):
the machine the port runs on is not promised OpenCV.

`MAGMA` is OpenCV 5.0.0's `COLORMAP_MAGMA` on the 256 gray levels, in RGB
order (OpenCV returns BGR and `cv2.imwrite` stores it as RGB, so a PNG
written from this table decodes to the same pixels as the JAX package's),
taken once from `cv2.applyColorMap(np.arange(256), COLORMAP_MAGMA)` and
stored here as a constant.
"""

from __future__ import annotations

import numpy as np

MAGMA = np.frombuffer(bytes.fromhex(
    "00000401000501010601010802010902020b02020d03030f030312040414050416060518"
    "06051a07061c08071e0907200a08220b09240c09260d0a290e0b2b100b2d110c2f120d31"
    "130d34140e36150e38160f3b180f3d19103f1a10421c10441d11471e114920114b21114e"
    "22115024125325125527125829115a2a115c2c115f2d11612f1163311165331067341069"
    "36106b38106c390f6e3b0f703d0f713f0f72400f74420f75440f76451077471078491078"
    "4a10794c117a4e117b4f127b51127c52137c54137d56147d57157e59157e5a167e5c167f"
    "5d177f5f187f601880621980641a80651a80671b80681c816a1c816b1d816d1d816e1e81"
    "701f81721f817320817521817621817822817922827b23827c23827e2482802582812581"
    "8326818426818627818827818928818b29818c29818e2a81902a81912b81932b80942c80"
    "962c80982d80992d809b2e7f9c2e7f9e2f7fa02f7fa1307ea3307ea5317ea6317da8327d"
    "aa337dab337cad347cae347bb0357bb2357bb3367ab5367ab73779b83779ba3878bc3978"
    "bd3977bf3a77c03a76c23b75c43c75c53c74c73d73c83e73ca3e72cc3f71cd4071cf4070"
    "d0416fd2426fd3436ed5446dd6456cd8456cd9466bdb476adc4869de4968df4a68e04c67"
    "e24d66e34e65e44f64e55064e75263e85362e95462ea5661eb5760ec5860ed5a5fee5b5e"
    "ef5d5ef05f5ef1605df2625df2645cf3655cf4675cf4695cf56b5cf66c5cf66e5cf7705c"
    "f7725cf8745cf8765cf9785df9795df97b5dfa7d5efa7f5efa815ffb835ffb8560fb8761"
    "fc8961fc8a62fc8c63fc8e64fc9065fd9266fd9467fd9668fd9869fd9a6afd9b6bfe9d6c"
    "fe9f6dfea16efea36ffea571fea772fea973feaa74feac76feae77feb078feb27afeb47b"
    "feb67cfeb77efeb97ffebb81febd82febf84fec185fec287fec488fec68afec88cfeca8d"
    "fecc8ffecd90fecf92fed194fed395fed597fed799fed89afdda9cfddc9efddea0fde0a1"
    "fde2a3fde3a5fde5a7fde7a9fde9aafdebacfcecaefceeb0fcf0b2fcf2b4fcf4b6fcf6b8"
    "fcf7b9fcf9bbfcfbbdfcfdbf"), np.uint8).reshape(256, 3)


def apply_colormap(u8: np.ndarray) -> np.ndarray:
    """uint8 (H, W) gray levels -> uint8 (H, W, 3) RGB through `MAGMA`."""
    return MAGMA[np.asarray(u8, np.uint8)]
