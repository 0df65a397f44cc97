"""A configuration's layer table written out from the program's own graph,
for the tests of the reference and the counts on a network that no cell
of the benchmark runs yet (ResNet-18: residual adds, 1x1 projections and a
global average pool)."""

OPS = {"pool": "maxpool", "global_pool": "global_avgpool"}


def table_from_graph(model: str, name: str, input_size: int = 224) -> dict:
    from repro_torch.net.graph import MODELS

    graph = MODELS[model](input_size=input_size)
    layers = []
    for n in graph.nodes:
        if n.op == "input":
            continue
        layer = {"op": OPS.get(n.op, n.op), "name": n.name,
                 "src": list(n.inputs)}
        if n.op in ("conv", "pool"):
            layer.update(k=n.K, s=n.S, pad=n.pad)
        if n.op in ("conv", "dense"):
            layer.update(out=n.n_out, relu=n.relu)
        layers.append(layer)
    return {"name": name, "port_model": model, "input_size": input_size,
            "in_channels": graph.in_channels,
            "num_classes": layers[-1]["out"],
            "compute_dtype": graph.compute_dtype, "tf32": False,
            "layers": layers}


def resnet18_table(input_size: int = 224) -> dict:
    return table_from_graph("resnet18", "resnet18_f32", input_size)
