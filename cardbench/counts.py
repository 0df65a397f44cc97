"""The work of a configuration, counted from its layer table alone.

FLOPs are 2 x the multiply-adds of every conv and dense layer of the
network, whatever a plan fuses, splits or launches: the same count holds
for any implementation.  Pools, adds and ReLUs are not counted.
"""

from __future__ import annotations

from cardbench.reference.cnn import layer_shapes

BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def _layers(cfg: dict):
    shapes = layer_shapes(cfg)
    prev = "image"
    for layer in cfg["layers"]:
        src = layer.get("src", [prev])[0]
        yield layer, shapes[src], shapes[layer["name"]]
        prev = layer["name"]


def conv_flops_per_image(cfg: dict) -> int:
    """2 x the multiply-adds of every conv layer for one image."""
    return sum(
        2 * out[0] ** 2 * layer["k"] ** 2 * inp[1] * out[1]
        for layer, inp, out in _layers(cfg) if layer["op"] == "conv"
    )


def dense_flops_per_image(cfg: dict) -> int:
    """2 x the multiply-adds of every dense layer for one image."""
    return sum(
        2 * inp[1] * out[1]
        for layer, inp, out in _layers(cfg) if layer["op"] == "dense"
    )


def flops_per_image(cfg: dict) -> int:
    return conv_flops_per_image(cfg) + dense_flops_per_image(cfg)


def conv_min_bytes(cfg: dict, rows: int) -> int:
    """The least HBM traffic of the conv layers of one forward of ``rows``
    images: every conv weight and bias read once, the image read once and
    the last conv layer's map written once (what a forward fused end to end
    would move)."""
    width = BYTES[cfg["compute_dtype"]]
    weights = image = last = 0
    for layer, inp, out in _layers(cfg):
        if layer["op"] != "conv":
            continue
        weights += (layer["k"] ** 2 * inp[1] + 1) * out[1]
        last = out[0] ** 2 * out[1]
    image = cfg["input_size"] ** 2 * cfg["in_channels"]
    return width * (weights + rows * (image + last))
