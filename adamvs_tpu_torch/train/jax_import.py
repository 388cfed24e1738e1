"""JAX variables -> port state_dict.

Inverts the JAX package's reference-checkpoint importers
(adamvs_tpu/train/torch_import.py:52-158): their tables map the reference
PyTorch names, which the port's modules use, onto the flax tree. This module
keeps its own copy of those tables, for AdaMVS and for MS-REDNet, and runs
them backwards:

- conv kernel, flax HWIO -> PyTorch OIHW (DHWIO -> OIDHW in 3-D);
- transposed-conv kernel, flax HWIO (spatially flipped, since flax
  correlates) -> PyTorch IOHW, un-flipped; MS-REDNet's stride-1 head
  ``upconv2d`` is a transposed conv in the reference and a plain conv in
  flax, and takes this path too;
- BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_mean/
  running_var;
- GroupNorm scale/bias -> weight/bias.

``from_jax_extras`` does the same for one block of ``nn/extras.py``; a
flax ``ConvTranspose`` there (``transpose_kernel=False``) correlates the
dilated input with its kernel as it is, so the port's transposed conv takes
it flipped, the same transform as the models' transposed convs.

Inputs are nested mappings of numpy-convertible arrays (a flax
``{"params", "batch_stats"}`` tree); no JAX import is needed.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch


def _feature_plan() -> list[tuple[str, str, str]]:
    """(PyTorch prefix, flax path under 'feature', kind)."""
    plan = []
    trunk = [
        ("conv0.0", "ConvBlock_0"), ("conv0.1", "ConvBlock_1"),
        ("conv1.0", "ConvBlock_2"), ("conv1.1", "ConvBlock_3"), ("conv1.2", "ConvBlock_4"),
        ("conv2.0", "ConvBlock_5"), ("conv2.1", "ConvBlock_6"), ("conv2.2", "ConvBlock_7"),
    ]
    for t, f in trunk:
        plan.append((f"{t}.conv", f"{f}/FastConv_0", "conv"))
        plan.append((f"{t}.bn", f"{f}/BatchNorm_0", "bn"))
    spp = [
        ("branch1_1", "_SPPBranch_0"), ("branch1_2", "_SPPBranch_1"),
        ("branch2_1", "_SPPBranch_2"), ("branch2_2", "_SPPBranch_3"),
        ("branch3_1", "_SPPBranch_4"), ("branch3_2", "_SPPBranch_5"),
    ]
    for t, f in spp:  # element 0 of the branch is the pool
        plan.append((f"{t}.1.conv", f"{f}/ConvBlock_0/FastConv_0", "conv"))
        plan.append((f"{t}.1.bn", f"{f}/ConvBlock_0/BatchNorm_0", "bn"))
    for t, f in [("deconv1", "DeConvFuse_0"), ("deconv2", "DeConvFuse_1")]:
        plan.append((f"{t}.deconv.conv", f"{f}/DeconvBlock_0/FastConvTranspose_0", "convt"))
        plan.append((f"{t}.deconv.bn", f"{f}/DeconvBlock_0/BatchNorm_0", "bn"))
        plan.append((f"{t}.conv.conv", f"{f}/ConvBlock_0/FastConv_0", "conv"))
        plan.append((f"{t}.conv.bn", f"{f}/ConvBlock_0/BatchNorm_0", "bn"))
    for i in range(3):
        plan.append((f"out{i + 1}", f"FastConv_{i}", "conv"))
    return plan


def _reg2d_plan() -> list[tuple[str, str, str]]:
    plan = []
    for i in range(7):
        plan.append((f"conv{i}.conv", f"FastConv_{i}", "conv"))
        plan.append((f"conv{i}.bn", f"BatchNorm_{i}", "bn"))
    for j, t in enumerate(("conv7", "conv9", "conv11")):
        plan.append((f"{t}.0", f"FastConvTranspose_{j}", "convt"))
        plan.append((f"{t}.1", f"BatchNorm_{7 + j}", "bn"))
    plan.append(("prob", "FastConv_7", "conv"))
    return plan


def _reg_fuse_plan(up: bool) -> list[tuple[str, str, str]]:
    return [
        ("conv1.conv", "cell/ConvReLU_0/FastConv_0", "conv"),
        ("conv_gru1.conv_gates.0", "cell/ConvGRUCell_0/FastConv_0", "conv"),
        ("conv_gru1.convc.0", "cell/ConvGRUCell_0/FastConv_1", "conv"),
        ("conv2.conv", "cell/ConvReLU_1/FastConv_0", "conv"),
        ("conv_gru2.conv_gates.0", "cell/ConvGRUCell_1/FastConv_0", "conv"),
        ("conv_gru2.convc.0", "cell/ConvGRUCell_1/FastConv_1", "conv"),
        ("upconv1", "cell/FastConvTranspose_0", "convt"),
        ("upconv2d", "cell/FastConvTranspose_1", "convt") if up
        else ("upconv2d", "cell/FastConv_0", "conv"),
    ]


def _red_feature_plan(arch_mode: str = "unet") -> list[tuple[str, str, str]]:
    """MS-REDNet feature net: (PyTorch prefix, flax path under 'feature',
    kind). In the ``fpn`` form the flax convs come in the order of their
    calls (adamvs_tpu/nn/featurenet.py:144-163): out1, then per finer level
    its lateral conv (``inner``) and its output conv."""
    plan = []
    trunk = [
        ("conv0.0", "ConvBlock_0"), ("conv0.1", "ConvBlock_1"),
        ("conv1.0", "ConvBlock_2"), ("conv1.1", "ConvBlock_3"), ("conv1.2", "ConvBlock_4"),
        ("conv2.0", "ConvBlock_5"), ("conv2.1", "ConvBlock_6"), ("conv2.2", "ConvBlock_7"),
    ]
    for t, f in trunk:
        plan.append((f"{t}.conv", f"{f}/FastConv_0", "conv"))
        plan.append((f"{t}.bn", f"{f}/BatchNorm_0", "bn"))
    if arch_mode == "fpn":
        return plan + [("out1", "FastConv_0", "conv"), ("inner1", "FastConv_1", "conv"),
                       ("out2", "FastConv_2", "conv"), ("inner2", "FastConv_3", "conv"),
                       ("out3", "FastConv_4", "conv")]
    for t, f in [("deconv1", "DeConvFuse_0"), ("deconv2", "DeConvFuse_1")]:
        plan.append((f"{t}.deconv.conv", f"{f}/DeconvBlock_0/FastConvTranspose_0", "convt"))
        plan.append((f"{t}.deconv.bn", f"{f}/DeconvBlock_0/BatchNorm_0", "bn"))
        plan.append((f"{t}.conv.conv", f"{f}/ConvBlock_0/FastConv_0", "conv"))
        plan.append((f"{t}.conv.bn", f"{f}/ConvBlock_0/BatchNorm_0", "bn"))
    for i in range(3):
        plan.append((f"out{i + 1}", f"FastConv_{i}", "conv"))
    return plan


def _red_reg_plan() -> list[tuple[str, str, str]]:
    """MS-REDNet ``RedCell`` under a stage's 'reg{i}' tree. The flax cell
    creates its GRUs deepest first, so conv_gru4 is GNConvGRUCell_0."""
    plan = [
        ("conv1.conv", "cell/ConvReLU_0/FastConv_0", "conv"),
        ("conv2.conv", "cell/ConvReLU_1/FastConv_0", "conv"),
        ("conv3.conv", "cell/ConvReLU_2/FastConv_0", "conv"),
        ("upconv3.conv", "cell/ConvTransReLU_0/FastConvTranspose_0", "convt"),
        ("upconv2.conv", "cell/ConvTransReLU_1/FastConvTranspose_0", "convt"),
        ("upconv1.conv", "cell/ConvTransReLU_2/FastConvTranspose_0", "convt"),
        ("upconv2d", "cell/FastConv_0", "convt"),
    ]
    for gru, cellname in [("conv_gru4", "GNConvGRUCell_0"), ("conv_gru3", "GNConvGRUCell_1"),
                          ("conv_gru2", "GNConvGRUCell_2"), ("conv_gru1", "GNConvGRUCell_3")]:
        plan += [
            (f"{gru}.gate_conv", f"cell/{cellname}/FastConv_0", "conv"),
            (f"{gru}.reset_gate_norm", f"cell/{cellname}/GroupNorm_0", "gn"),
            (f"{gru}.update_gate_norm", f"cell/{cellname}/GroupNorm_1", "gn"),
            (f"{gru}.output_conv", f"cell/{cellname}/FastConv_1", "conv"),
            (f"{gru}.output_norm", f"cell/{cellname}/GroupNorm_2", "gn"),
        ]
    return plan


def _get(tree: Mapping, path: str):
    node = tree
    for part in path.split("/"):
        if part not in node:
            return None
        node = node[part]
    return node


def _t(x) -> torch.Tensor:
    return torch.tensor(np.array(x, np.float32))


def _apply_plan(params: Mapping, stats: Mapping, prefix: str, plan, sd: dict) -> None:
    for tname, fpath, kind in plan:
        node = _get(params, fpath)
        if node is None:  # a level the model does not have (fewer stages)
            continue
        full = f"{prefix}{tname}"
        if kind == "gn":
            sd[f"{full}.weight"] = _t(node["scale"])
            sd[f"{full}.bias"] = _t(node["bias"])
            continue
        if kind == "bn":
            st = _get(stats, fpath)
            sd[f"{full}.weight"] = _t(node["scale"])
            sd[f"{full}.bias"] = _t(node["bias"])
            sd[f"{full}.running_mean"] = _t(st["mean"])
            sd[f"{full}.running_var"] = _t(st["var"])
            sd[f"{full}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
            continue
        k = np.asarray(node["kernel"], np.float32)
        if kind == "conv":  # HWIO -> OIHW, DHWIO -> OIDHW
            w = k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))
        else:
            w = k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]  # HWIO -> IOHW, un-flipped
        sd[f"{full}.weight"] = _t(w)
        if "bias" in node:
            sd[f"{full}.bias"] = _t(node["bias"])


def from_jax_variables(variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """The port ``AdaMVS`` state_dict holding the weights of a JAX ``AdaMVS``
    ``{"params", "batch_stats"}`` tree."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict = OrderedDict()
    _apply_plan(params["feature"], stats.get("feature", {}), "feature.", _feature_plan(), sd)
    _apply_plan(params["reg2d"], stats.get("reg2d", {}), "DepthNet.0.reg.", _reg2d_plan(), sd)
    i = 0
    while f"reg_fuse{i + 1}" in params:
        _apply_plan(params[f"reg_fuse{i + 1}"], {}, f"DepthNet.{i}.reg_fuse.",
                    _reg_fuse_plan(up=i < 2), sd)
        i += 1
    return sd


def from_jax_msrednet_variables(variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """The port ``MSREDNet`` state_dict holding the weights of a JAX
    ``MSREDNet`` ``{"params", "batch_stats"}`` tree, its feature net in the
    ``unet`` or (no ``DeConvFuse`` up steps, more than one stage) the ``fpn``
    form: ``MSREDNet(arch_mode=...)`` of the port loads it."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    feature = params["feature"]
    fpn = "DeConvFuse_0" not in feature and "FastConv_1" in feature
    sd: dict = OrderedDict()
    _apply_plan(feature, stats.get("feature", {}), "feature.",
                _red_feature_plan("fpn" if fpn else "unet"), sd)
    i = 0
    while f"reg{i + 1}" in params:
        _apply_plan(params[f"reg{i + 1}"], {}, f"cost_regularization.{i}.", _red_reg_plan(), sd)
        i += 1
    return sd


def _extras_plan(block) -> list[tuple[str, str, str]]:
    """(port prefix, flax path, kind) of an ``nn/extras.py`` block."""
    from ..nn import extras

    if isinstance(block, extras.ConvLSTMCell):
        return [("conv", "Conv_0", "conv")]
    if isinstance(block, extras.ConvBn3D):
        return [("conv", "Conv_0", "conv"), ("bn", "BatchNorm_0", "bn")]
    if isinstance(block, extras.ConvGn):
        return [("conv", "Conv_0", "conv"), ("gn", "GroupNorm_0", "gn")]
    if isinstance(block, extras.ConvTransGnReLU):
        return [("conv", "ConvTranspose_0", "convt"), ("gn", "GroupNorm_0", "gn")]
    deform = [("offset", "offset", "conv"), ("mask", "mask", "conv"), ("proj", "proj", "conv")]
    if isinstance(block, extras.DeformConvBlock):
        return deform
    if isinstance(block, extras.DeformConvGnReLU):
        return [(f"conv.{t}", f"DeformConvBlock_0/{f}", k) for t, f, k in deform] + [
            ("gn", "GroupNorm_0", "gn")]
    raise TypeError(f"not a block of nn/extras.py: {type(block).__name__}")


def from_jax_extras(block, variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """The state_dict of ``block``, a module of ``nn/extras.py``, holding the
    weights of the matching flax block's ``{"params", "batch_stats"}`` tree
    (an unmodulated ``DeformConvBlock`` has no ``mask``)."""
    sd: dict = OrderedDict()
    _apply_plan(variables["params"], variables.get("batch_stats", {}), "", _extras_plan(block), sd)
    return sd
