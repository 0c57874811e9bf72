"""ResNet-18 (CIFAR variant), the counterpart of the JAX package's
``models/resnet.py``: the benchmark model of the ResNet-18/CIFAR-10 step.

3x3 stem (no maxpool), four groups of two residual blocks at 64/128/256/512
channels, stride-2 downsampling at group entry, global average pool, fc.
``norm="group"`` (GroupNorm, stateless: the pipeline and the bench) or
``norm="batch"`` (BatchNorm with running statistics).

The modules take NCHW tensors; on the card they are kept in
``torch.channels_last`` memory, which is the JAX package's NHWC byte order,
so cuDNN takes its NHWC tensor-core paths.  The arithmetic is flax's, and
five places where torch's defaults differ are matched on purpose:

- ``padding="SAME"``: flax pads ``max((out - 1) * s + k - n, 0)`` rows, the
  smaller half first.  At stride 1 (3x3) that is ``(1, 1)``; at stride 2 on
  an even size it is ``(0, 1)``, not torch's ``(1, 1)``, so :class:`Conv`
  pads explicitly there.  The 1x1 stride-2 shortcut pads nothing.
- GroupNorm's epsilon is 1e-6 (torch's default is 1e-5); groups
  ``min(32, filters // 4)``, with scale and bias.
- BatchNorm (:class:`~ddl25spring_tpu_torch.models.layers.BatchNorm`):
  flax's ``momentum=0.9`` keeps 0.9 of the running statistics per step
  (torch's ``momentum=0.1``), and its running variance takes the *biased*
  batch variance, where torch's ``BatchNorm2d`` takes the unbiased one;
  epsilon 1e-5.
- dtypes: parameters are float32; the convs and norms compute in
  ``dtype`` (the casts are explicit, as in :mod:`~ddl25spring_tpu_torch.
  models.llama`; ``torch.autocast`` would keep ``group_norm`` in float32),
  the mean pool in ``dtype`` and the head in float32.
- initialisation: flax's ``lecun_normal`` (truncated normal, fan-in) for
  conv and dense kernels, zero biases, unit scales, drawn from an explicit
  ``torch.Generator``.

Submodules carry flax's names (``Conv_0``, ``GroupNorm_0``,
``ResNetBlock_3``, ``Dense_0``, ...), so :func:`load_flax_params` and
:func:`export_params` move a whole-model tree, or a per-stage tree of
:func:`make_resnet_stages`, across with only the layout changes: conv
kernels HWIO <-> OIHW, dense ``[in, out]`` <-> ``Linear.weight [out, in]``,
norm ``scale`` <-> ``weight``, BatchNorm ``batch_stats`` <-> buffers
(:mod:`~ddl25spring_tpu_torch.models.flax_bridge`).  ``param_tree()`` gives
the parameters in flax's flatten order, so the DP step plans the same
gradient buckets as the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ddl25spring_tpu_torch.models import flax_bridge
from ddl25spring_tpu_torch.models.layers import BatchNorm, dense, lecun_normal
from ddl25spring_tpu_torch.models.flax_bridge import (  # noqa: F401 -- the model's bridge
    export_batch_stats,
    export_grads,
    export_params,
    load_flax_params,
)

def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``padding="SAME"`` along one dimension: ``(before, after)``."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``nn.Conv(features, (k, k), (s, s), padding="SAME", use_bias=False)``;
    the weight is OIHW float32, cast to the input's dtype where it is used."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, generator: torch.Generator):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = lecun_normal((cout, cin, k, k), cin * k * k, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (top, bottom), (left, right) = (same_pads(n, self.k, self.stride) for n in x.shape[-2:])
        w = self.weight.to(x.dtype)
        if top == bottom and left == right:
            return F.conv2d(x, w, stride=self.stride, padding=(top, left))
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=self.stride)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm``: epsilon 1e-6; computes in the input's dtype."""

    def __init__(self, channels: int):
        super().__init__(min(32, channels // 4), channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def _norm(kind: str, channels: int) -> nn.Module:
    if kind == "group":
        return GroupNorm(channels)
    if kind == "batch":
        return BatchNorm(channels)
    raise ValueError(f"norm must be 'group' or 'batch', got {kind!r}")


def _norm_name(kind: str) -> str:
    return "GroupNorm" if kind == "group" else "BatchNorm"


class ResNetBlock(nn.Module):
    """Two 3x3 convs with norms, and a 1x1 conv + norm on the shortcut when the
    shape changes (flax ``Conv_0``, ``Conv_1``, ``Conv_2``)."""

    def __init__(self, cin: int, filters: int, strides: int, norm: str,
                 generator: torch.Generator):
        super().__init__()
        n = _norm_name(norm)
        self.Conv_0 = Conv(cin, filters, 3, strides, generator)
        self.add_module(f"{n}_0", _norm(norm, filters))
        self.Conv_1 = Conv(filters, filters, 3, 1, generator)
        self.add_module(f"{n}_1", _norm(norm, filters))
        self.norms = [getattr(self, f"{n}_{i}") for i in range(2)]
        self.shortcut = cin != filters or strides != 1
        if self.shortcut:
            self.Conv_2 = Conv(cin, filters, 1, strides, generator)
            self.add_module(f"{n}_2", _norm(norm, filters))
            self.norms.append(getattr(self, f"{n}_2"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norms[0](self.Conv_0(x)))
        y = self.norms[1](self.Conv_1(y))
        residual = self.norms[2](self.Conv_2(x)) if self.shortcut else x
        return F.relu(y + residual)


def block_plan(width: int) -> list[tuple[int, int]]:
    """The (filters, stride) sequence every ResNet-18 variant here shares."""
    w = width
    return [
        (w, 1), (w, 1),
        (2 * w, 2), (2 * w, 1),
        (4 * w, 2), (4 * w, 1),
        (8 * w, 2), (8 * w, 1),
    ]


STAGE_CUT = 4  # blocks 0:4 -> stage 0, 4:8 -> stage 1 (the 2-stage PP split)


class ResNet18Stage(nn.Module):
    """``block_plan[lo:hi]``, with the stem (``Conv_0`` + norm) in front when
    ``first`` and the pool and classifier (``Dense_0``) behind when ``last``.
    ``first=True, last=True`` over all eight blocks is the whole network."""

    def __init__(self, lo: int, hi: int, first: bool = False, last: bool = False,
                 num_classes: int = 10, width: int = 64, norm: str = "group",
                 dtype: torch.dtype = torch.float32, *, device="cpu",
                 generator: torch.Generator):
        super().__init__()
        self.lo, self.hi, self.first, self.last = lo, hi, first, last
        self.dtype, self.norm = dtype, norm
        plan = block_plan(width)
        if first:
            self.Conv_0 = Conv(3, width, 3, 1, generator)
            self.add_module(f"{_norm_name(norm)}_0", _norm(norm, width))
        cin = width if lo == 0 else plan[lo - 1][0]
        for i, (filters, stride) in enumerate(plan[lo:hi]):
            self.add_module(f"ResNetBlock_{i}",
                            ResNetBlock(cin, filters, stride, norm, generator))
            cin = filters
        if last:
            self.Dense_0 = dense(cin, num_classes, generator)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype)
        if self.first:
            y = F.relu(getattr(self, f"{_norm_name(self.norm)}_0")(self.Conv_0(y)))
        for i in range(self.hi - self.lo):
            y = getattr(self, f"ResNetBlock_{i}")(y)
        if self.last:
            # the head computes in its parameters' dtype: float32, as flax's
            # Dense(dtype=float32), whatever ``dtype`` the body used
            y = self.Dense_0(y.mean((2, 3)).to(self.Dense_0.weight.dtype))
        return y

    def param_tree(self) -> dict:
        return flax_bridge.tree((flax_bridge.flax_path(n), t) for n, t in self.named_parameters())


def ResNet18(num_classes: int = 10, norm: str = "batch", width: int = 64,
             dtype: torch.dtype = torch.float32, *, device="cpu",
             generator: torch.Generator) -> ResNet18Stage:
    """The whole network (flax ``ResNet18``): one stage over all eight blocks."""
    return ResNet18Stage(0, len(block_plan(width)), first=True, last=True,
                         num_classes=num_classes, width=width, norm=norm, dtype=dtype,
                         device=device, generator=generator)


def resnet_stage_cuts(num_stages: int) -> list[int]:
    """Block-plan cut points for S pipeline stages (FLOPs-balanced: the stem
    rides stage 0, the cheap head stage S-1)."""
    cuts = {1: [], 2: [STAGE_CUT], 3: [3, 6], 4: [2, 4, 6]}
    if num_stages not in cuts:
        raise ValueError(
            f"resnet pipeline supports S in (1, 2, 3, 4), got {num_stages}"
        )
    return cuts[num_stages]


def resnet_stage(index: int, num_stages: int, num_classes: int = 10, width: int = 64,
                 dtype: torch.dtype = torch.float32, *, device="cpu",
                 seed: int = 0) -> ResNet18Stage:
    """Stage ``index`` of :func:`make_resnet_stages`, built alone: a pipeline
    rank holds only its own stage."""
    cuts = [0] + resnet_stage_cuts(num_stages) + [len(block_plan(width))]
    return ResNet18Stage(cuts[index], cuts[index + 1], first=index == 0,
                         last=index == num_stages - 1, num_classes=num_classes, width=width,
                         norm="group", dtype=dtype, device=device,
                         generator=torch.Generator().manual_seed(seed + index))


def make_resnet_stages(num_stages: int, num_classes: int = 10, width: int = 64,
                       dtype: torch.dtype = torch.float32, *, device="cpu",
                       seed: int = 0) -> list[ResNet18Stage]:
    """The S GroupNorm stages of the benchmark ResNet-18 (S in 1..4), stage
    ``i`` initialised from ``torch.Generator().manual_seed(seed + i)``.  Applied
    in order they are ``ResNet18(norm="group")``; each has its own flax-named
    tree (blocks numbered from 0 within the stage).  The 2-stage split is the
    JAX package's ``ResNet18Stage0``/``ResNet18Stage1``."""
    resnet_stage_cuts(num_stages)  # S outside 1..4 raises
    return [resnet_stage(i, num_stages, num_classes, width, dtype, device=device, seed=seed)
            for i in range(num_stages)]


def split_params_for_stages(params: dict, num_stages: int) -> list[dict]:
    """A whole-model flax ``params`` tree (``ResNet18(norm="group")``) cut into
    the trees of :func:`make_resnet_stages`: the stem on stage 0, each stage's
    blocks renumbered from ``ResNetBlock_0``, ``Dense_0`` on the last stage."""
    cuts = [0] + resnet_stage_cuts(num_stages) + [len(block_plan(1))]
    out = []
    for i in range(num_stages):
        tree = {f"ResNetBlock_{j - cuts[i]}": params[f"ResNetBlock_{j}"]
                for j in range(cuts[i], cuts[i + 1])}
        if i == 0:
            tree.update(Conv_0=params["Conv_0"], GroupNorm_0=params["GroupNorm_0"])
        if i == num_stages - 1:
            tree["Dense_0"] = params["Dense_0"]
        out.append(tree)
    return out


def boundary_shapes(num_stages: int, num_classes: int = 10, width: int = 64,
                    size: int = 32) -> list[tuple]:
    """Each stage's output shape per sample (no batch dimension) in the
    ``num_stages`` split of :func:`make_resnet_stages`, from the block plan:
    the channels of the stage's last block at ``size`` over the strides so
    far (``"SAME"`` rounds up), then the logits."""
    plan, shapes = block_plan(width), []
    for cut in resnet_stage_cuts(num_stages):
        n = size
        for _, stride in plan[:cut]:
            n = -(-n // stride)
        shapes.append((plan[cut - 1][0], n, n))
    return shapes + [(num_classes,)]

