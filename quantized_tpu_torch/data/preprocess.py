"""Preprocessing pipelines of the port (counterpart of
``quantized_tpu/data/preprocess.py``, the same numpy code, so a seeded
transform gives the same bytes in both packages).

The eval path follows torchvision: Resize(shorter side, bilinear) ->
CenterCrop -> scale to [0, 1] -> per-channel normalize. The training
augmentations (random crops, flips, color jitter, PCA lighting) are numpy
versions of the reference's transform classes. The uint8 ingest of the
engines folds ``IMAGENET_MEAN`` and ``IMAGENET_STD`` into its quantize.

Output layout is NHWC float32, the layout the port's engines take.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

try:
    from PIL import Image

    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False

# reference __imagenet_stats (preprocess.py ~L8-12)
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
# reference __imagenet_pca (~L14-22)
IMAGENET_PCA_EIGVAL = np.asarray([0.2175, 0.0188, 0.0045], np.float32)
IMAGENET_PCA_EIGVEC = np.asarray(
    [
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ],
    np.float32,
)
CIFAR10_MEAN = np.asarray([0.491, 0.482, 0.447], np.float32)
CIFAR10_STD = np.asarray([0.247, 0.243, 0.262], np.float32)
MNIST_MEAN = np.asarray([0.1307], np.float32)
MNIST_STD = np.asarray([0.3081], np.float32)


def resize_shorter(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision Scale/Resize: shorter side -> size, bilinear (PIL)."""
    h, w = img.shape[:2]
    if h <= w:
        nh, nw = size, max(1, round(w * size / h))
    else:
        nh, nw = max(1, round(h * size / w)), size
    if _HAVE_PIL:
        pil = Image.fromarray(img.astype(np.uint8)) if img.dtype != np.uint8 else Image.fromarray(img)
        return np.asarray(pil.resize((nw, nh), Image.BILINEAR))
    # nearest fallback
    yi = (np.arange(nh) * h / nh).astype(int)
    xi = (np.arange(nw) * w / nw).astype(int)
    return img[yi][:, xi]


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return img[top : top + size, left : left + size]


def normalize(img01: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return ((img01 - mean) / std).astype(np.float32)


def random_crop_padded(img: np.ndarray, size: int, pad: int, rng: np.random.Generator) -> np.ndarray:
    """reference pad_random_crop: reflect 0-pad then random crop (CIFAR)."""
    p = np.pad(img, ((pad, pad), (pad, pad), (0, 0)))
    top = int(rng.integers(0, 2 * pad + 1))
    left = int(rng.integers(0, 2 * pad + 1))
    return p[top : top + size, left : left + size]


def random_horizontal_flip(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return img[:, ::-1] if rng.random() < 0.5 else img


def lighting(img01: np.ndarray, alphastd: float, rng: np.random.Generator) -> np.ndarray:
    """reference Lighting (AlexNet-style PCA noise)."""
    if alphastd == 0:
        return img01
    alpha = rng.normal(0.0, alphastd, 3).astype(np.float32)
    shift = IMAGENET_PCA_EIGVEC @ (alpha * IMAGENET_PCA_EIGVAL)
    return (img01 + shift).astype(np.float32)


def random_sized_crop(img: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    """reference inception_preproccess / RandomSizedCrop."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(0.08, 1.0) * area
        aspect = rng.uniform(3.0 / 4.0, 4.0 / 3.0)
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if rng.random() < 0.5:
            cw, ch = ch, cw
        if cw <= w and ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            crop = img[top : top + ch, left : left + cw]
            return resize_exact(crop, size, size)
    return center_crop(resize_shorter(img, size), size)


def grayscale(img01: np.ndarray) -> np.ndarray:
    """Reference ``Grayscale`` (preprocess.py ~L100-115): luma with the
    0.299/0.587/0.114 weights, replicated to all 3 channels. HWC [0,1]."""
    luma = (
        0.299 * img01[..., 0] + 0.587 * img01[..., 1] + 0.114 * img01[..., 2]
    ).astype(np.float32)
    return np.repeat(luma[..., None], 3, axis=-1)


def _lerp(img01: np.ndarray, target: np.ndarray, alpha: float) -> np.ndarray:
    """torch ``img.lerp_(gs, alpha)``: img + alpha * (gs - img)."""
    return (img01 + np.float32(alpha) * (target - img01)).astype(np.float32)


def saturation_jitter(img01: np.ndarray, var: float, rng: np.random.Generator) -> np.ndarray:
    """Reference ``Saturation(var)``: lerp toward grayscale by U(0, var)."""
    return _lerp(img01, grayscale(img01), rng.uniform(0.0, var))


def brightness_jitter(img01: np.ndarray, var: float, rng: np.random.Generator) -> np.ndarray:
    """Reference ``Brightness(var)``: lerp toward black by U(0, var)."""
    return _lerp(img01, np.zeros_like(img01), rng.uniform(0.0, var))


def contrast_jitter(img01: np.ndarray, var: float, rng: np.random.Generator) -> np.ndarray:
    """Reference ``Contrast(var)``: lerp toward the scalar mean of the
    grayscale image by U(0, var)."""
    gs = grayscale(img01)
    return _lerp(img01, np.full_like(img01, gs.mean(dtype=np.float64)), rng.uniform(0.0, var))


def color_jitter(
    img01: np.ndarray,
    brightness: float = 0.4,
    contrast: float = 0.4,
    saturation: float = 0.4,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Reference ``ColorJitter`` = ``RandomOrder([Brightness, Contrast,
    Saturation])`` (preprocess.py ~L150-200): the enabled jitters applied in
    a random order."""
    rng = rng or np.random.default_rng()
    ops = []
    if brightness:
        ops.append(lambda im: brightness_jitter(im, brightness, rng))
    if contrast:
        ops.append(lambda im: contrast_jitter(im, contrast, rng))
    if saturation:
        ops.append(lambda im: saturation_jitter(im, saturation, rng))
    for i in rng.permutation(len(ops)):
        img01 = ops[i](img01)
    return img01


def resize_exact(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if _HAVE_PIL:
        pil = Image.fromarray(img.astype(np.uint8)) if img.dtype != np.uint8 else Image.fromarray(img)
        return np.asarray(pil.resize((w, h), Image.BILINEAR))
    yi = (np.arange(h) * img.shape[0] / h).astype(int)
    xi = (np.arange(w) * img.shape[1] / w).astype(int)
    return img[yi][:, xi]


@dataclasses.dataclass
class Transform:
    """A picklable preprocessing pipeline (reference get_transform result)."""

    name: str
    input_size: int
    scale_size: int
    mean: np.ndarray
    std: np.ndarray
    augment: bool
    pad: int = 0
    inception: bool = False
    lighting_std: float = 0.0
    jitter: float = 0.0  # ColorJitter strength (ref inception_color_preproccess: 0.4)

    def __call__(self, img_u8: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """uint8 HWC (or HW for mono) -> normalized f32 HWC."""
        if img_u8.ndim == 2:
            img_u8 = img_u8[:, :, None]
        if self.augment:
            rng = rng or np.random.default_rng()
            if self.inception:
                img = random_sized_crop(img_u8, self.input_size, rng)
            elif self.pad:
                img = random_crop_padded(img_u8, self.input_size, self.pad, rng)
            else:
                img = center_crop(resize_shorter(img_u8, self.scale_size), self.input_size)
            img = random_horizontal_flip(img, rng)
            img01 = img.astype(np.float32) / 255.0
            if self.jitter:
                img01 = color_jitter(img01, self.jitter, self.jitter, self.jitter, rng)
            if self.lighting_std:
                img01 = lighting(img01, self.lighting_std, rng)
        else:
            img = img_u8
            if img.shape[0] != self.input_size or img.shape[1] != self.input_size:
                img = center_crop(resize_shorter(img, self.scale_size), self.input_size)
            img01 = img.astype(np.float32) / 255.0
        return normalize(img01, self.mean, self.std)


def get_transform(
    name: str = "imagenet",
    input_size: Optional[int] = None,
    scale_size: Optional[int] = None,
    augment: bool = False,
) -> Transform:
    """Reference get_transform dispatcher (preprocess.py ~L35-80):
    imagenet 224/256, cifar10 32/40 pad_random_crop(4), mnist 28."""
    if name in ("imagenet", "imagenet_inception", "imagenet_inception_color"):
        input_size = input_size or 224
        scale_size = scale_size or 256
        inception = augment and name != "imagenet"
        color = augment and name.endswith("color")
        return Transform(
            name,
            input_size,
            scale_size,
            IMAGENET_MEAN,
            IMAGENET_STD,
            augment,
            inception=inception,
            lighting_std=0.1 if color else 0.0,
            jitter=0.4 if color else 0.0,
        )
    if name in ("cifar10", "cifar100"):
        input_size = input_size or 32
        scale_size = scale_size or 40
        return Transform(name, input_size, scale_size, CIFAR10_MEAN, CIFAR10_STD, augment, pad=4)
    if name == "mnist":
        input_size = input_size or 28
        return Transform(name, input_size, input_size, MNIST_MEAN, MNIST_STD, augment)
    raise ValueError(f"unknown transform {name!r}")
