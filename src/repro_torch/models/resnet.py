"""ResNet-50 (v1.5): the paper's own image-classification workload, the
port of ``repro.models.resnet``.

The reference is plain ``jnp`` and reaches no Pallas kernel: its
convolutions are ``lax.conv_general_dilated`` and its pool a
``reduce_window``.  The port computes them with ``F.conv2d`` (cuDNN on the
card) and ``F.max_pool2d``; no hand-written kernel runs here.

Layouts: convolution weights are stored OIHW and activations run NCHW
(the reference: HWIO and NHWC; :func:`~repro_torch.models.params.
resnet_from_jax` permutes its weights).  Padding is JAX's ``"SAME"``,
which at stride 2 puts the odd row and column at the end (the 7x7/2 stem at
224 pads 2 before and 3 after, each 3x3/2 0 and 1); PyTorch's ``padding=``
is symmetric and would give the same shapes with shifted values, so every
convolution and the pool pad explicitly with :func:`same_pads`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from ..device import resolve_device, resolve_dtype
from .params import P, count_params, init_params


@dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet50"
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    num_classes: int = 1000
    img_size: int = 224

    def reduced(self) -> "ResNetConfig":
        return ResNetConfig(
            name=self.name + "-reduced",
            stage_sizes=(1, 1, 1, 1),
            width=16,
            num_classes=64,
            img_size=32,
        )


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """``(before, after)`` padding of one spatial axis of size ``n`` under
    JAX's ``"SAME"`` for a window ``k`` at ``stride`` (``lax.padtype_to_pads``):
    ``ceil(n / stride)`` outputs, the odd pad row at the end."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv_defs(cin: int, cout: int, k: int) -> P:
    return P((cout, cin, k, k), std=math.sqrt(2.0 / (k * k * cin)))


def _bn_defs(c: int) -> Dict[str, P]:
    # inference-mode batchnorm folded to scale + bias
    return {"scale": P((c,), "ones"), "bias": P((c,), "zeros")}


class ResNet:
    """Functional ResNet-50 v1.5 (stride 2 in the 3x3 of each downsampling
    block) on ``device`` (``cuda`` unless given; raises where there is none)
    in ``dtype`` (bf16 on the card, float32 on the CPU unless given)."""

    def __init__(self, cfg: ResNetConfig, device: Union[str, torch.device, None] = None,
                 dtype: Union[str, torch.dtype, None] = None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype, self.device)

    def param_defs(self) -> Dict[str, Any]:
        cfg = self.cfg
        w = cfg.width
        stages: Dict[str, Any] = {}
        cin = w
        for i, n_blocks in enumerate(cfg.stage_sizes):
            cmid = w * (2 ** i)
            cout = cmid * 4
            blocks = {}
            for b in range(n_blocks):
                blk = {
                    "conv1": _conv_defs(cin, cmid, 1), "bn1": _bn_defs(cmid),
                    "conv2": _conv_defs(cmid, cmid, 3), "bn2": _bn_defs(cmid),
                    "conv3": _conv_defs(cmid, cout, 1), "bn3": _bn_defs(cout),
                }
                if b == 0:
                    blk["proj"] = _conv_defs(cin, cout, 1)
                    blk["proj_bn"] = _bn_defs(cout)
                blocks[str(b)] = blk
                cin = cout
            stages[str(i)] = blocks
        return {
            "stem": {"conv": _conv_defs(3, w, 7), "bn": _bn_defs(w)},
            "stages": stages,
            "head": P((8 * w * 4, cfg.num_classes), std=0.01),
        }

    def param_count(self) -> int:
        return count_params(self.param_defs())

    def init(self, seed: int = 0):
        """Random weights on the model's device and dtype from a seeded
        ``torch.Generator`` on that device."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return init_params(self.param_defs(), gen, self.device, self.dtype)

    @staticmethod
    def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
        k = w.shape[-1]
        top, bottom = same_pads(x.shape[2], k, stride)
        left, right = same_pads(x.shape[3], k, stride)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, stride=stride)

    @staticmethod
    def _max_pool(x: torch.Tensor) -> torch.Tensor:
        """3x3/2 max pool, ``"SAME"``: the pad rows hold ``-inf``."""
        top, bottom = same_pads(x.shape[2], 3, 2)
        left, right = same_pads(x.shape[3], 3, 2)
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
        return F.max_pool2d(x, 3, 2)

    @staticmethod
    def _bn(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
        return x * p["scale"][:, None, None] + p["bias"][:, None, None]

    def forward(self, params, images: torch.Tensor) -> torch.Tensor:
        """images ``(b, H, W, 3)`` -> float32 logits ``(b, num_classes)``.
        The images move to the model's device and dtype once, channels
        first; the head's mean and product run in float32."""
        cfg = self.cfg
        x = images.to(device=self.device, dtype=self.dtype).permute(0, 3, 1, 2)
        x = self._conv(x, params["stem"]["conv"], stride=2)
        x = self._max_pool(F.relu(self._bn(x, params["stem"]["bn"])))
        for i, n_blocks in enumerate(cfg.stage_sizes):
            stage = params["stages"][str(i)]
            for b in range(n_blocks):
                blk = stage[str(b)]
                stride = 2 if (b == 0 and i > 0) else 1
                residual = x
                y = F.relu(self._bn(self._conv(x, blk["conv1"]), blk["bn1"]))
                y = F.relu(self._bn(self._conv(y, blk["conv2"], stride), blk["bn2"]))
                y = self._bn(self._conv(y, blk["conv3"]), blk["bn3"])
                if "proj" in blk:
                    residual = self._bn(self._conv(x, blk["proj"], stride), blk["proj_bn"])
                x = F.relu(y + residual)
        return x.float().mean(dim=(2, 3)) @ params["head"].float()

    def macs(self, batch: int = 1) -> int:
        """Multiply-accumulates of one forward over ``batch`` images at the
        config's size: every convolution's ``out_h * out_w * cout * cin *
        k * k`` and the head's product (the pool, the norms and the
        residual adds are not counted)."""
        cfg = self.cfg
        total = 0
        n = cfg.img_size

        def conv(n, cin, cout, k, stride):
            nonlocal total
            out = -(-n // stride)
            total += out * out * cout * cin * k * k
            return out

        w = cfg.width
        n = conv(n, 3, w, 7, 2)
        n = -(-n // 2)                                  # the pool
        cin = w
        for i, n_blocks in enumerate(cfg.stage_sizes):
            cmid = w * (2 ** i)
            cout = cmid * 4
            for b in range(n_blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                conv(n, cin, cmid, 1, 1)
                n_out = conv(n, cmid, cmid, 3, stride)
                conv(n_out, cmid, cout, 1, 1)
                if b == 0:
                    conv(n, cin, cout, 1, stride)
                n, cin = n_out, cout
        total += cin * cfg.num_classes
        return total * batch
