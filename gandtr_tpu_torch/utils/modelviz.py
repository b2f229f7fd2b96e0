"""Architecture views (counterpart of gandtr_tpu/utils/modelviz.py): a
parameter table, and the network's forward as a Graphviz DOT graph. The
reference renders a torchviz autograd graph for its HTML report
(mdir/learning/network.py:272-274); the JAX package draws the jaxpr of
the apply; here it is the operator graph of the forward traced by
torch.fx (`make_fx`, one node an ATen operator, the counterpart of a
jaxpr equation). No graphviz binary is needed."""
import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx


def param_summary(module):
    """[(name, shape, dtype, size)] of a module's parameters (or of a
    state dict's tensors), and the total element count."""
    items = (module.named_parameters() if isinstance(module, torch.nn.Module)
             else module.items())
    rows, total = [], 0
    for name, t in items:
        shape = tuple(t.shape)
        size = int(np.prod(shape)) if shape else 1
        rows.append((name, shape, str(t.dtype).replace("torch.", ""), size))
        total += size
    return rows, total


def format_summary(module, title="model"):
    rows, total = param_summary(module)
    width = max([len(r[0]) for r in rows] + [10])
    lines = ["%s (%d params)" % (title, total)]
    for name, shape, dtype, size in rows:
        lines.append("  %-*s %-18s %-10s %d" % (width, name, str(shape),
                                                dtype, size))
    return "\n".join(lines)


def fx_dot(fn, *example_args, max_nodes=400):
    """DOT digraph of `fn` traced on the example arguments: an ellipse for
    each input and output, a box for each operator, edges by value flow;
    past `max_nodes` operators an ellipsis node stands for the rest."""
    graph = make_fx(fn)(*example_args).graph
    lines = ["digraph fx {", "  rankdir=TB;",
             "  node [shape=box, fontsize=10];"]
    ids, count = {}, 0
    ops = [n for n in graph.nodes if n.op == "call_function"]
    for node in graph.nodes:
        if node.op == "placeholder":
            ids[node] = "in%d" % len(ids)
            val = node.meta.get("val")
            shape = tuple(val.shape) if hasattr(val, "shape") else ""
            lines.append('  %s [label="input%d %s", shape=ellipse, '
                         'fillcolor=lightblue, style=filled];'
                         % (ids[node], len(ids) - 1, shape))
        elif node.op == "call_function":
            if count >= max_nodes:
                lines.append('  trunc [label="... %d more operators", '
                             'shape=plaintext];' % (len(ops) - count))
                break
            count += 1
            ids[node] = "e%d" % count
            target = getattr(node.target, "__name__", str(node.target))
            lines.append('  %s [label="%s"];' % (ids[node], target))
            for arg in node.all_input_nodes:
                if arg in ids:
                    lines.append("  %s -> %s;" % (ids[arg], ids[node]))
        elif node.op == "output":
            outs = node.all_input_nodes
            for i, arg in enumerate(outs):
                lines.append('  out%d [label="output%d", shape=ellipse, '
                             'fillcolor=lightgreen, style=filled];' % (i, i))
                if arg in ids:
                    lines.append("  %s -> out%d;" % (ids[arg], i))
    lines.append("}")
    return "\n".join(lines)


def architecture_graph(net, input_shape=(1, 64, 64, 3),
                       dtype=torch.float32, max_nodes=400):
    """The DOT graph of a network's forward (a WrappedNet's `apply`, or a
    module) on a zero input of `input_shape`, NHWC, on the network's
    device: only the traced structure matters, not the values."""
    module = getattr(net, "module", net)
    param = next(module.parameters(), None)
    device = param.device if param is not None else torch.device("cpu")
    x = torch.zeros(input_shape, dtype=dtype, device=device)
    fwd = net.apply if hasattr(net, "apply") and hasattr(net, "module") \
        else net
    with torch.no_grad():
        return fx_dot(fwd, x, max_nodes=max_nodes)
