"""``fused_conv_share.bulk``: the share of the window's conv FLOPs that ran
inside launches of two or more conv levels, in %.

For each bucket the window used, the plan is the program's own
``auto_partition(harness.port_graph(cfg), batch=bucket)`` under the
``ServeConfig`` defaults the harness builds the engine with, the same plan
its cache hands the engine; each batch counts ``bucket`` rows of each
conv.  So the share is the sum over buckets of batches x rows x FLOPs of
the convs inside the plan's pyramids of Q >= 2, over the same sum for
every conv.  None where the program cannot plan the configuration or the
window ran no batch.

The program's spans of the residual joins and its ``fused_convs`` counts
(``repro_torch.obs``) are not read here: the harness installs none of the
program's tracing, so they are read by ``repro_torch.obs.explain --run``
and a profiling run, not by a reader.
"""

from cardbench import harness
from cardbench.reference.cnn import layer_shapes


def _conv_flops(cfg: dict) -> dict:
    """2 x the multiply-adds of each conv layer for one image, by name."""
    shapes = layer_shapes(cfg)
    prev, out = "image", {}
    for layer in cfg["layers"]:
        src = layer.get("src", [prev])[0]
        if layer["op"] == "conv":
            size, ch = shapes[layer["name"]]
            out[layer["name"]] = (2 * size ** 2 * layer["k"] ** 2
                                  * shapes[src][1] * ch)
        prev = layer["name"]
    return out


def read(run):
    try:
        from repro_torch.net.partition import auto_partition
        from repro_torch.net.serve import ServeConfig

        graph = harness.port_graph(run.cell.cfg)
    except (ImportError, KeyError, ValueError):
        return None
    config = ServeConfig()
    flops = _conv_flops(run.cell.cfg)
    fused = total = 0
    for bucket, b in run.delta["buckets"].items():
        plan = auto_partition(graph, budget=config.budget, batch=bucket,
                              prefer_region=config.prefer_region,
                              compute_dtype=config.compute_dtype)
        rows = b["batches"] * bucket
        fused += rows * sum(flops[name] for p in plan.pyramids
                            if p.q_convs >= 2 for name in p.node_names
                            if name in flops)
        total += rows * sum(flops.values())
    return 100.0 * fused / total if total else None
