"""On-device batched augmentation and preprocessing (counterpart of
``tensorflowdistributedlearning_tpu/data/augment.py``). Tensors are NHWC, as
in the JAX package, and every function runs on the device of its input.

Training augmentation is the reference's transform list: REFLECT pad 40 px,
random transpose (p=0.5), optional brightness jitter, horizontal and
vertical flips (p=0.5 each), rotation U(±rotate_range°), shifts
U(±range)·height, optional zoom-crop, one composed inverse affine warp per
image (bilinear for the image, nearest for the mask, zero fill outside), the
central crop back to the input size, and the Laplacian second channel.

Classification augmentation is the JAX package's: a per-image horizontal
flip and a reflect-padded random crop (:func:`augment_classification_batch`),
then optionally mixup or cutmix, which pair each image with a permuted
partner and return ``labels_b`` and the mixing weight ``lam`` for the loss.

Randomness comes from an explicit ``torch.Generator`` (on the device of the
batch); it cannot reproduce ``jax.random``'s bits, so the two packages agree
on the warp given one matrix and on the distribution of the sampled
matrices, not on the draws. The classification transforms are each split
into a draw (``*_draws``: flip bits, crop offsets, permutation, ``lam``, box
centre) and an apply that is a function of the batch and the draws, so the
apply can be held bit for bit against the JAX package on JAX's draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

# TGS Salt dataset intensity statistics (the JAX package's MEAN/STD)
MEAN = 0.47194585
STD = 0.16105755

# the isotropic 3x3 Laplacian stencil of the JAX package
_LAPLACE_KERNEL = (
    (0.5, 1.0, 0.5),
    (1.0, -6.0, 1.0),
    (0.5, 1.0, 0.5),
)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Knob set of the reference's ``read_and_preprocess``, same defaults."""

    horizontal_flip: bool = True
    vertical_flip: bool = True
    rotate_range: float = 10.0  # degrees
    crop_probability: float = 0.5  # the trainer passes 0, as the reference did
    crop_min_percent: float = 0.9
    crop_max_percent: float = 1.1
    height_shift_range: float = 0.2
    width_shift_range: float = 0.2
    brightness_range: float = 0.0
    pad: int = 40  # REFLECT padding before warping
    transpose_probability: float = 0.5


def normalize(image: torch.Tensor) -> torch.Tensor:
    """(x - MEAN) / STD."""
    return (image - MEAN) / STD


def laplacian(images: torch.Tensor) -> torch.Tensor:
    """Per-channel 3x3 Laplacian of a [B, H, W, C] batch, SAME zero padding."""
    c = images.shape[-1]
    kernel = torch.tensor(_LAPLACE_KERNEL, dtype=images.dtype, device=images.device)
    kernel = kernel.repeat(c, 1, 1, 1)  # [C, 1, 3, 3], one filter per channel
    out = F.conv2d(images.permute(0, 3, 1, 2), kernel, padding=1, groups=c)
    return out.permute(0, 2, 3, 1)


def add_laplace_channel(images: torch.Tensor) -> torch.Tensor:
    """Concatenate the Laplacian as extra channels: [B,H,W,C] -> [B,H,W,2C]."""
    return torch.cat([images, laplacian(images)], dim=-1)


# ---------------------------------------------------------------------------
# Affine machinery. Matrices are 3x3 INVERSE warps: out-pixel (x, y) samples
# in-pixel M @ (x, y, 1)^T. Applying A then B composes as M_A @ M_B. The
# builders take [B] tensors and return [B, 3, 3] float32 stacks.
# ---------------------------------------------------------------------------


def _eye(n: int, device) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32, device=device).expand(n, 3, 3).clone()


def _stack_rows(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _hflip(width: float, n: int = 1, device=None) -> torch.Tensor:
    m = _eye(n, device)
    m[:, 0, 0] = -1.0
    m[:, 0, 2] = width - 1.0
    return m


def _vflip(height: float, n: int = 1, device=None) -> torch.Tensor:
    m = _eye(n, device)
    m[:, 1, 1] = -1.0
    m[:, 1, 2] = height - 1.0
    return m


def _rotation(angle: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """Rotation about the image center by ``angle`` [B] radians."""
    angle = angle.float()
    cos, sin = torch.cos(angle), torch.sin(angle)
    cx, cy = (width - 1.0) / 2.0, (height - 1.0) / 2.0
    zero, one = torch.zeros_like(angle), torch.ones_like(angle)
    return _stack_rows(
        [
            [cos, -sin, cx - cos * cx + sin * cy],
            [sin, cos, cy - sin * cx - cos * cy],
            [zero, zero, one],
        ]
    )


def _translation(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    tx, ty = tx.float(), ty.float()
    zero, one = torch.zeros_like(tx), torch.ones_like(tx)
    return _stack_rows([[one, zero, tx], [zero, one, ty], [zero, zero, one]])


def _zoom_crop(pct: torch.Tensor, off_x: torch.Tensor, off_y: torch.Tensor) -> torch.Tensor:
    pct = pct.float()
    zero, one = torch.zeros_like(pct), torch.ones_like(pct)
    return _stack_rows([[pct, zero, off_x.float()], [zero, pct, off_y.float()], [zero, zero, one]])


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """``lax.round``'s default rounding (half away from zero)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def _warp_batch(
    images: torch.Tensor, matrices: torch.Tensor, order: int, out_hw: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """Inverse-warp [B, H, W, C] by [B, 3, 3] with
    ``jax.scipy.ndimage.map_coordinates(mode="constant", cval=0)``
    semantics: ``order=1`` bilinear over the four neighbours, each zero when
    outside; ``order=0`` nearest with half-away-from-zero rounding. With
    ``out_hw`` only the central ``out_hw`` window of the warped image is
    computed (what ``central_crop`` of the full warp returns)."""
    b, h, w, c = images.shape
    oh, ow = (h, w) if out_hw is None else out_hw
    top, left = (h - oh) // 2, (w - ow) // 2
    dev = images.device
    ys = torch.arange(top, top + oh, dtype=torch.float32, device=dev)[:, None].expand(oh, ow)
    xs = torch.arange(left, left + ow, dtype=torch.float32, device=dev)[None, :].expand(oh, ow)
    m = matrices.float()[:, :, :, None, None]  # [B, 3, 3, 1, 1]
    in_x = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]  # [B, oh, ow]
    in_y = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    flat = images.reshape(b, h * w, c)

    def sample(iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        index = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, oh * ow, 1).expand(b, oh * ow, c)
        values = torch.gather(flat, 1, index).reshape(b, oh, ow, c)
        return torch.where(valid[..., None], values, torch.zeros((), dtype=values.dtype, device=dev))

    if order == 0:
        return sample(_round_half_away(in_y).long(), _round_half_away(in_x).long())
    if order != 1:
        raise NotImplementedError("order must be 0 (nearest) or 1 (bilinear)")
    y0, x0 = torch.floor(in_y), torch.floor(in_x)
    wy1, wx1 = in_y - y0, in_x - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    y0, x0 = y0.long(), x0.long()
    # map_coordinates' product order: (y0,x0), (y0,x1), (y1,x0), (y1,x1)
    out = (wy0 * wx0)[..., None] * sample(y0, x0)
    out = out + (wy0 * wx1)[..., None] * sample(y0, x0 + 1)
    out = out + (wy1 * wx0)[..., None] * sample(y0 + 1, x0)
    out = out + (wy1 * wx1)[..., None] * sample(y0 + 1, x0 + 1)
    return out.to(images.dtype)


def _apply_warp(image: torch.Tensor, matrix: torch.Tensor, order: int) -> torch.Tensor:
    """Inverse-warp one [H, W, C] image by a 3x3 affine matrix (``order=1``
    bilinear, ``order=0`` nearest, zero fill)."""
    return _warp_batch(image[None], matrix.reshape(1, 3, 3), order)[0]


def central_crop(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Static central crop of [..., H, W, C]."""
    h, w = x.shape[-3], x.shape[-2]
    th, tw = out_hw
    top, left = (h - th) // 2, (w - tw) // 2
    return x[..., top : top + th, left : left + tw, :]


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of numpy/jnp ``mode="reflect"`` padding (edge not
    repeated), for any ``pad`` including pads wider than ``n``."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j < n, j, period - j)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """REFLECT-pad the spatial axes of [B, H, W, C] by ``pad``."""
    if pad == 0:
        return x
    x = x.index_select(1, _reflect_index(x.shape[1], pad, x.device))
    return x.index_select(2, _reflect_index(x.shape[2], pad, x.device))


def _uniform(generator: torch.Generator, n: int, low: float, high, device) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=device)
    return low + u * (high - low)


def _sample_affine(
    generator: torch.Generator, n: int, cfg: AugmentConfig, height: float, width: float, device=None
) -> torch.Tensor:
    """[n, 3, 3] per-image affines (flips ∘ rotation ∘ shift ∘ crop), the
    reference's transform list, drawn from ``generator``."""
    eye = _eye(n, device)
    m = eye
    if cfg.horizontal_flip:
        coin = torch.rand(n, generator=generator, device=device) < 0.5
        m = m @ torch.where(coin[:, None, None], _hflip(width, n, device), eye)
    if cfg.vertical_flip:
        coin = torch.rand(n, generator=generator, device=device) < 0.5
        m = m @ torch.where(coin[:, None, None], _vflip(height, n, device), eye)
    if cfg.rotate_range:
        max_rad = cfg.rotate_range / 180.0 * math.pi
        m = m @ _rotation(_uniform(generator, n, -max_rad, max_rad, device), height, width)
    # per-image shifts, both scaled by the height as in the reference
    zero = torch.zeros(n, device=device)
    tx = (
        _uniform(generator, n, -cfg.width_shift_range, cfg.width_shift_range, device) * height
        if cfg.width_shift_range
        else zero
    )
    ty = (
        _uniform(generator, n, -cfg.height_shift_range, cfg.height_shift_range, device) * height
        if cfg.height_shift_range
        else zero
    )
    m = m @ _translation(tx, ty)
    if cfg.crop_probability > 0:
        pct = _uniform(generator, n, cfg.crop_min_percent, cfg.crop_max_percent, device)
        off_x = torch.rand(n, generator=generator, device=device) * (width * torch.abs(1.0 - pct))
        off_y = torch.rand(n, generator=generator, device=device) * (height * torch.abs(1.0 - pct))
        coin = torch.rand(n, generator=generator, device=device) < cfg.crop_probability
        m = m @ torch.where(coin[:, None, None], _zoom_crop(pct, off_x, off_y), eye)
    return m


def _augment(
    generator: torch.Generator,
    images: torch.Tensor,
    masks: torch.Tensor,
    cfg: AugmentConfig,
    out_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment [B, H, W, 1] square image/mask pairs (the JAX package's
    ``_augment_one``, batched)."""
    n, dev = images.shape[0], images.device
    images = _reflect_pad(images, cfg.pad)
    masks = _reflect_pad(masks, cfg.pad)
    do_t = (torch.rand(n, generator=generator, device=dev) < cfg.transpose_probability)[:, None, None, None]
    images = torch.where(do_t, images.transpose(1, 2), images)
    masks = torch.where(do_t, masks.transpose(1, 2), masks)
    if cfg.brightness_range > 0:
        delta = _uniform(generator, n, -cfg.brightness_range, cfg.brightness_range, dev)
        images = images + delta[:, None, None, None]
    h, w = images.shape[1], images.shape[2]
    matrices = _sample_affine(generator, n, cfg, float(h), float(w), dev)
    images = _warp_batch(images, matrices, order=1, out_hw=out_hw)
    masks = _warp_batch(masks, matrices, order=0, out_hw=out_hw)
    return images, masks


def _augment_one(
    generator: torch.Generator, image: torch.Tensor, mask: torch.Tensor, cfg: AugmentConfig, out_hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment one [H, W, 1] image/mask pair."""
    images, masks = _augment(generator, image[None], mask[None], cfg, out_hw)
    return images[0], masks[0]


def augment_batch(
    generator: torch.Generator,
    images: torch.Tensor,
    masks: torch.Tensor,
    cfg: AugmentConfig = AugmentConfig(),
    out_hw: Optional[Tuple[int, int]] = None,
) -> Dict[str, torch.Tensor]:
    """Batched augmentation + Laplacian channel: [B, H, W, 1] normalized
    images and binary masks -> {'images': [B, h, w, 2], 'labels': [B, h, w, 1]}."""
    if out_hw is None:
        out_hw = (images.shape[1], images.shape[2])
    aug_images, aug_masks = _augment(generator, images, masks, cfg, tuple(out_hw))
    return {"images": add_laplace_channel(aug_images), "labels": aug_masks}


# -- classification -------------------------------------------------------------


def classification_augment_draws(
    generator: torch.Generator, n: int, crop_padding: int = 4, flip: bool = True, device=None
) -> Dict[str, Optional[torch.Tensor]]:
    """The draws of :func:`augment_classification_batch` for ``n`` images:
    ``flips`` [n] bool (p = 0.5; None without ``flip``), crop offsets
    ``ys``, ``xs`` [n] int64 in ``[0, 2·crop_padding]`` (None without
    padding)."""
    flips = torch.rand(n, generator=generator, device=device) < 0.5 if flip else None
    if crop_padding <= 0:
        return {"flips": flips, "ys": None, "xs": None}
    hi = 2 * crop_padding + 1
    ys = torch.randint(0, hi, (n,), generator=generator, device=device)
    xs = torch.randint(0, hi, (n,), generator=generator, device=device)
    return {"flips": flips, "ys": ys, "xs": xs}


def apply_classification_augment(
    images: torch.Tensor, flips: Optional[torch.Tensor], ys: Optional[torch.Tensor], xs: Optional[torch.Tensor],
    crop_padding: int = 4,
) -> torch.Tensor:
    """Mirror the rows whose ``flips`` is set, then crop each [H, W] window
    at ``(ys, xs)`` out of the batch REFLECT-padded by ``crop_padding``."""
    if flips is not None:
        images = torch.where(flips[:, None, None, None], images.flip(2), images)
    if ys is None:
        return images
    b, h, w, _ = images.shape
    padded = _reflect_pad(images, crop_padding)
    rows = ys.long()[:, None] + torch.arange(h, device=images.device)  # [B, H]
    cols = xs.long()[:, None] + torch.arange(w, device=images.device)  # [B, W]
    batch = torch.arange(b, device=images.device)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]


def augment_classification_batch(
    generator: torch.Generator, images: torch.Tensor, crop_padding: int = 4, flip: bool = True
) -> torch.Tensor:
    """Per-image random horizontal flip and reflect-padded random crop of
    [B, H, W, C] images (the ImageNet/CIFAR recipe); ``flip=False`` keeps
    the chirality (text, digits)."""
    draws = classification_augment_draws(generator, images.shape[0], crop_padding, flip, images.device)
    return apply_classification_augment(images, crop_padding=crop_padding, **draws)


def beta_sample(generator: torch.Generator, n: int, alpha: float, device=None) -> torch.Tensor:
    """[n] float32 draws of Beta(alpha, alpha) by Jöhnk's rejection method
    on uniforms (``torch.distributions`` takes no generator): X = U^(1/a),
    Y = V^(1/a), kept when X + Y <= 1, the draw X / (X + Y); in logs, so
    a small U cannot underflow. Each round keeps a share
    Γ(1+a)² / Γ(1+2a) of its candidates (0.95 at a = 0.2, 0.5 at a = 1);
    the rounds end when every row has one, which reads one flag on the
    host per round."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    todo = torch.ones(n, dtype=torch.bool, device=device)
    while True:
        log_x = torch.log(torch.rand(n, generator=generator, device=device, dtype=torch.float64)) / alpha
        log_y = torch.log(torch.rand(n, generator=generator, device=device, dtype=torch.float64)) / alpha
        log_sum = torch.logaddexp(log_x, log_y)
        take = todo & (log_sum <= 0)
        out = torch.where(take, torch.exp(log_x - log_sum).float(), out)
        todo = todo & ~take
        if not bool(todo.any()):
            return out


def mixup_draws(generator: torch.Generator, n: int, alpha: float = 0.2, device=None) -> Dict[str, torch.Tensor]:
    """The draws of :func:`mixup_batch`: a permutation ``perm`` [n] and
    ``lam`` [n] ~ Beta(alpha, alpha)."""
    perm = torch.randperm(n, generator=generator, device=device)
    return {"perm": perm, "lam": beta_sample(generator, n, alpha, device)}


def apply_mixup(images: torch.Tensor, labels: torch.Tensor, perm: torch.Tensor, lam: torch.Tensor):
    """Mixup (arXiv:1710.09412) of each image with its partner ``perm``:
    ``lam`` folded to ``max(lam, 1 - lam)`` (so ``labels`` stay the
    majority target), ``lam·x + (1 - lam)·x[perm]``; returns the batch with
    ``labels``, ``labels_b`` and ``lam`` (float32) for the loss."""
    lam = lam.to(images.dtype)
    lam = torch.maximum(lam, 1.0 - lam)
    w = lam[:, None, None, None]
    mixed = w * images + (1.0 - w) * images[perm]
    return {"images": mixed, "labels": labels, "labels_b": labels[perm], "lam": lam.float()}


def mixup_batch(generator: torch.Generator, images: torch.Tensor, labels: torch.Tensor, alpha: float = 0.2):
    """Mixup with draws from ``generator`` (:func:`apply_mixup`)."""
    return apply_mixup(images, labels, **mixup_draws(generator, images.shape[0], alpha, images.device))


def cutmix_draws(generator: torch.Generator, n: int, h: int, w: int, alpha: float = 1.0, device=None):
    """The draws of :func:`cutmix_batch`: ``perm`` [n], the box's area
    draw ``lam0`` [n] ~ Beta(alpha, alpha), and its centre ``cy`` [n] in
    [0, h), ``cx`` [n] in [0, w)."""
    perm = torch.randperm(n, generator=generator, device=device)
    lam0 = beta_sample(generator, n, alpha, device)
    cy = torch.randint(0, h, (n,), generator=generator, device=device)
    cx = torch.randint(0, w, (n,), generator=generator, device=device)
    return {"perm": perm, "lam0": lam0, "cy": cy, "cx": cx}


def apply_cutmix(images: torch.Tensor, labels: torch.Tensor, perm, lam0, cy, cx):
    """CutMix (arXiv:1905.04899): a box of sides ``int(sqrt(1 - lam0)·h)``
    by ``int(sqrt(1 - lam0)·w)`` centred at ``(cy, cx)``, clamped to the
    image, takes the partner's pixels; ``lam`` is the share of pixels that
    survive after the clamp, so the loss mixes what the pixels hold."""
    _, h, w, _ = images.shape
    dev = images.device
    cut = torch.sqrt(1.0 - lam0.float())
    bh = (cut * h).to(torch.int32)
    bw = (cut * w).to(torch.int32)
    cy, cx = cy.to(torch.int32), cx.to(torch.int32)
    y0 = torch.clamp(cy - bh // 2, 0, h)
    y1 = torch.clamp(cy + (bh + 1) // 2, 0, h)
    x0 = torch.clamp(cx - bw // 2, 0, w)
    x1 = torch.clamp(cx + (bw + 1) // 2, 0, w)
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    in_box = ((rows >= y0[:, None, None]) & (rows < y1[:, None, None])
              & (cols >= x0[:, None, None]) & (cols < x1[:, None, None]))  # [B, H, W]
    mixed = torch.where(in_box[..., None], images[perm], images)
    # the mean as XLA computes jnp.mean: the sum times the float32 reciprocal
    box_frac = in_box.float().sum(dim=(1, 2)) * torch.tensor(1.0 / (h * w), dtype=torch.float32, device=dev)
    return {"images": mixed, "labels": labels, "labels_b": labels[perm], "lam": 1.0 - box_frac}


def cutmix_batch(generator: torch.Generator, images: torch.Tensor, labels: torch.Tensor, alpha: float = 1.0):
    """CutMix with draws from ``generator`` (:func:`apply_cutmix`)."""
    _, h, w, _ = images.shape
    return apply_cutmix(images, labels, **cutmix_draws(generator, images.shape[0], h, w, alpha, images.device))


def prepare_classification_batch(
    generator: torch.Generator, batch: Dict[str, torch.Tensor], policy: str = "flip_crop"
) -> Dict[str, torch.Tensor]:
    """A train batch ``{"images", "labels"}`` under the augmentation policy
    (``TrainConfig.augmentation``): ``none`` passes it through; the others
    flip (not under ``crop``) and crop with a reflect padding of
    ``min(4, max(H // 8, 1))`` pixels (the jitter scales with the input,
    up to CIFAR's 4), then ``mixup`` and ``cutmix`` mix the pairs."""
    if policy == "none":
        return batch
    images = batch["images"]
    pad = min(4, max(images.shape[1] // 8, 1))
    images = augment_classification_batch(generator, images, crop_padding=pad,
                                          flip=policy in ("flip_crop", "mixup", "cutmix"))
    if policy == "mixup":
        return mixup_batch(generator, images, batch["labels"])
    if policy == "cutmix":
        return cutmix_batch(generator, images, batch["labels"])
    return {"images": images, "labels": batch["labels"]}


def prepare_eval_batch(images: torch.Tensor, masks: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Eval preparation: no geometry, just the Laplacian channel."""
    return {"images": add_laplace_channel(images), "labels": masks}


# Test-time augmentation (the JAX package's TTA_TRANSFORMS, tta_transform and
# tta_inverse). All four transforms are involutions, so each is its own
# inverse.

TTA_TRANSFORMS = ("vertical", "horizontal", "transpose", "none")


def tta_transform(x: torch.Tensor, transformation: str) -> torch.Tensor:
    """Apply a named TTA transform to a [B, H, W, C] batch."""
    if transformation == "vertical":
        return torch.flip(x, dims=(1,))
    if transformation == "horizontal":
        return torch.flip(x, dims=(2,))
    if transformation == "transpose":
        return x.transpose(1, 2).contiguous()
    if transformation == "none":
        return x
    raise ValueError(f"Unknown transformation {transformation}")


def tta_inverse(x: torch.Tensor, transformation: str) -> torch.Tensor:
    """Invert a named TTA transform (all are involutions)."""
    return tta_transform(x, transformation)
