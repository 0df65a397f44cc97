"""Plain PyTorch reference of a CNN configuration's layer table.

A configuration file (``cardbench/configs/<name>.json``) lists its layers in
order; each names its inputs under ``src`` (default: the layer before it).
This module walks that table with ``torch.nn.functional`` and nothing else:
no kernel, plan, cache or batching of the program under test.

Layouts, which the benchmark's weights follow and hands to both sides:
images are NHWC float32; a conv weight is ``(k, k, c_in, c_out)`` with a
bias ``(c_out,)``; a dense weight is ``(features_in, features_out)`` with a
bias; ``flatten`` orders a map's features as (row, column, channel).

``precision="float32"`` runs IEEE float32 (TF32 off).  ``precision="tf32"``
is the correctness control: every conv and dense operand is rounded to
TF32's 10-bit mantissa and the TF32 paths of cuDNN and cuBLAS are allowed,
the step below float32 that a later change might be tempted to take.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32")


def layer_shapes(cfg: dict) -> dict[str, tuple[int, int]]:
    """``{layer name: (map size, channels)}``; a flat vector has size 0."""
    shapes = {"image": (cfg["input_size"], cfg["in_channels"])}
    prev = "image"
    for layer in cfg["layers"]:
        srcs = layer.get("src", [prev])
        size, ch = shapes[srcs[0]]
        op = layer["op"]
        if op in ("conv", "maxpool"):
            size = (size + 2 * layer["pad"] - layer["k"]) // layer["s"] + 1
            ch = layer["out"] if op == "conv" else ch
        elif op == "global_avgpool":
            size = 0
        elif op == "flatten":
            size, ch = 0, size * size * ch
        elif op == "dense":
            if size:
                raise ValueError(f"{layer['name']}: dense needs a flat input")
            ch = layer["out"]
        elif op == "add":
            if shapes[srcs[1]] != (size, ch):
                raise ValueError(f"{layer['name']}: operands disagree")
        elif op != "relu":
            raise ValueError(f"{layer['name']}: unknown op {op!r}")
        shapes[layer["name"]] = (size, ch)
        prev = layer["name"]
    return shapes


def weight_leaves(cfg: dict) -> list[tuple[str, tuple[int, ...], int]]:
    """``(layer name, weight shape, fan_in)`` of every conv and dense layer,
    in table order; each layer also has a bias of its output width."""
    shapes = layer_shapes(cfg)
    prev, leaves = "image", []
    for layer in cfg["layers"]:
        src = layer.get("src", [prev])[0]
        c_in = shapes[src][1]
        if layer["op"] == "conv":
            k = layer["k"]
            leaves.append((layer["name"], (k, k, c_in, layer["out"]),
                           k * k * c_in))
        elif layer["op"] == "dense":
            leaves.append((layer["name"], (c_in, layer["out"]), c_in))
        prev = layer["name"]
    return leaves


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), to nearest even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _tf32_switches(allow: bool):
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def forward(cfg: dict, params: dict, x: torch.Tensor,
            precision: str = "float32") -> torch.Tensor:
    """Logits ``(rows, classes)`` of NHWC images ``x`` under ``params``
    (``{name: (weight, bias)}``), on ``x``'s device."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    low = precision == "tf32"
    op_in = _tf32 if low else (lambda t: t)
    values = {"image": x.float().permute(0, 3, 1, 2)}  # NCHW inside
    prev = "image"
    with _tf32_switches(low), torch.no_grad():
        for layer in cfg["layers"]:
            srcs = layer.get("src", [prev])
            a = values[srcs[0]]
            op = layer["op"]
            if op == "conv":
                w, b = params[layer["name"]]
                y = F.conv2d(op_in(a), op_in(w.permute(3, 2, 0, 1)), b,
                             stride=layer["s"], padding=layer["pad"])
                y = F.relu(y) if layer["relu"] else y
            elif op == "maxpool":
                y = F.max_pool2d(a, layer["k"], layer["s"],
                                 padding=layer["pad"])
            elif op == "add":
                y = a + values[srcs[1]]
            elif op == "relu":
                y = F.relu(a)
            elif op == "global_avgpool":
                y = a.mean(dim=(2, 3))
            elif op == "flatten":
                y = a.permute(0, 2, 3, 1).reshape(a.shape[0], -1)
            else:  # dense
                w, b = params[layer["name"]]
                y = op_in(a) @ op_in(w) + b
                y = F.relu(y) if layer["relu"] else y
            values[layer["name"]] = y
            prev = layer["name"]
    return values[prev]
