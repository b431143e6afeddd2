"""The FID InceptionV3: the feature extractor of FID / IS / KID / PRC.

Counterpart of ``dsml_thesis_tpu/metrics/inception.py``. The network is
torchvision's InceptionV3 (no auxiliary head) with the FID modifications of
pytorch-fid / torch-fidelity: the average pools inside the Inception blocks
do not count their padding (``count_include_pad=False``), and the last
block (Mixed_7c) pools its pool branch with a max. Its parameters carry
torchvision's names, so that the user's ``pt_inception-2015-12-05-*.pth``
state_dict loads as it is (``convert_fid_inception``). BatchNorm runs on its
running statistics (eps 1e-3) whatever the module's mode.

Input: RGB in [-1, 1], NHWC, at 299 x 299 (``preprocess`` resizes any size).
Output: the 2048-d pool3 features (FID, KID, PRC) and 1008 logits (IS).
On the card, ``make_feature_fn`` runs the convolutions without TF32
(``metrics.image.full_fp32``): FID moves with the features' last digits.
"""
from __future__ import annotations

from typing import Callable, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .image import full_fp32


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3, running statistics) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel_size=1, stride: int = 1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        return F.relu(F.batch_norm(self.conv(x), bn.running_mean,
                                   bn.running_var, bn.weight, bn.bias,
                                   training=False, eps=bn.eps))


def _avg_pool_nocount(x):
    """3 x 3 stride-1 average pool that does not count its padding."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64)
        self.branch5x5_1 = BasicConv2d(cin, 48)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd,
                          F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192)
        self.branch7x7_1 = BasicConv2d(cin, c7)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_nocount(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, max_pool_branch: bool = False):
        super().__init__()
        self.max_pool_branch = max_pool_branch   # Mixed_7c (FIDInceptionE_2)
        self.branch1x1 = BasicConv2d(cin, 320)
        self.branch3x3_1 = BasicConv2d(cin, 384)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        pool = (F.max_pool2d(x, 3, stride=1, padding=1)
                if self.max_pool_branch else _avg_pool_nocount(x))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pool)],
                         dim=1)


class FIDInceptionV3(nn.Module):
    """[B, 299, 299, 3] in [-1, 1] -> (pool [B, 2048], logits
    [B, num_classes])."""

    def __init__(self, num_classes: int = 1008):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, max_pool_branch=True)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).contiguous()
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        pool = x.mean(dim=(2, 3))   # global average pool -> 2048
        return pool, self.fc(pool)


def preprocess(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """[-1, 1] NHWC of any size -> ``size`` x ``size`` by bilinear
    interpolation at half-pixel centres without antialiasing (pytorch-fid's
    ``F.interpolate``; ``jax.image.resize(..., antialias=False)`` gives the
    same), also where it downscales."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False, antialias=False)
    return x.permute(0, 2, 3, 1)


def convert_fid_inception(sd: Mapping,
                          num_classes: int = 1008) -> FIDInceptionV3:
    """A ``FIDInceptionV3`` in eval mode, on the CPU, holding a
    pt_inception / torchvision InceptionV3 state_dict (tensors or numpy
    arrays) in fp32. Keys the network does not have (torchvision's
    ``AuxLogits``) are left out; a missing key or a shape that differs
    raises."""
    model = FIDInceptionV3(num_classes)
    picked = {}
    for k, own in model.state_dict().items():
        if k.endswith("num_batches_tracked"):   # unread at eval
            continue
        if k not in sd:
            raise KeyError(f"the Inception state_dict has no {k!r}")
        v = sd[k]
        v = v.detach().cpu() if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.asarray(v))
        picked[k] = v.float()
    model.load_state_dict(picked, strict=False)
    return model.eval()


def make_feature_fn(model: FIDInceptionV3
                    ) -> Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                        torch.Tensor]]:
    """images [-1, 1] NHWC (a tensor or an array, any size) -> (pool,
    logits) in fp32 on the model's device, through ``preprocess``, without
    a gradient and without TF32."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def fn(images):
        x = torch.as_tensor(images, dtype=torch.float32, device=device)
        with full_fp32():
            return model(preprocess(x))

    return fn
