"""Inference-graph visualizer: deployment spec -> DOT / ASCII.

The reference ships a notebook helper that draws a SeldonDeployment's
predictor graphs with graphviz (reference: notebooks/visualizer.py);
this is the CLI-first equivalent for TpuDeployment specs.  Emits plain
DOT text (no graphviz dependency — render with ``dot -Tsvg`` anywhere)
or an ASCII tree for terminals.

    seldon-tpu-torch-graph examples/combiner_pipeline.yaml            # ascii
    seldon-tpu-torch-graph examples/mab_abtest.yaml --format dot -o g.dot
"""

from __future__ import annotations

import argparse
from typing import List, Optional

# one fill per node role so graphs read at a glance (colorblind-safe
# light fills; role is also spelled out in the label)
_TYPE_FILLS = {
    "MODEL": "#cfe2f3",
    "ROUTER": "#fde9c8",
    "COMBINER": "#d9ead3",
    "TRANSFORMER": "#ead1dc",
    "OUTPUT_TRANSFORMER": "#ead1dc",
    "UNKNOWN_TYPE": "#eeeeee",
}


def _node_detail(unit) -> str:
    """Second label line: what actually serves this node."""
    if unit.implementation:
        return unit.implementation
    if unit.component_class:
        return unit.component_class.rsplit(".", 1)[-1]
    if unit.component is not None:
        return type(unit.component).__name__
    if unit.endpoint is not None:
        return f"{unit.endpoint.transport.lower()}://{unit.endpoint.host}:{unit.endpoint.port}"
    return ""


def _dot_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def to_dot(spec) -> str:
    """DOT digraph: one cluster per predictor, traffic-weighted edges
    from the gateway, dashed edges to shadow predictors, dotted borders
    on `remote: true` (DCN) nodes."""
    lines: List[str] = [
        f'digraph "{_dot_escape(spec.name)}" {{',
        "  rankdir=TB;",
        '  node [shape=box, style="rounded,filled", fontname="Helvetica"];',
        f'  gateway [label="gateway\\n{_dot_escape(spec.name)}", fillcolor="#f4f4f4"];',
    ]
    # stable ids: predictor index + node path
    for pi, predictor in enumerate(spec.predictors):
        lines.append(f"  subgraph cluster_{pi} {{")
        extras = []
        if predictor.shadow:
            extras.append("shadow")
        if predictor.hpa:
            extras.append("hpa")
        if predictor.explainer:
            extras.append("explainer")
        title = f"{predictor.name} (replicas={predictor.replicas}"
        if extras:
            title += ", " + ",".join(extras)
        title += ")"
        lines.append(f'    label="{_dot_escape(title)}";')
        lines.append("    style=dashed;" if predictor.shadow else "    style=solid;")

        def emit(unit, path: str) -> str:
            node_id = f"n{pi}_{path}"
            label = _dot_escape(unit.name)
            detail = _node_detail(unit)
            if detail:
                label += f"\\n{unit.type}: {_dot_escape(detail)}"
            else:
                label += f"\\n{unit.type}"
            fill = _TYPE_FILLS.get(unit.type, "#eeeeee")
            style = "rounded,filled"
            if unit.remote:
                style += ",dotted"  # DCN edge: out-of-process worker
            lines.append(f'    {node_id} [label="{label}", fillcolor="{fill}", style="{style}"];')
            for ci, child in enumerate(unit.children):
                child_id = emit(child, f"{path}_{ci}")
                lines.append(f"    {node_id} -> {child_id};")
            return node_id

        root_id = emit(predictor.graph, "0")
        lines.append("  }")
        edge_attrs = []
        if predictor.shadow:
            edge_attrs.append("style=dashed")
            edge_attrs.append('label="shadow"')
        elif predictor.traffic:
            edge_attrs.append(f'label="{predictor.traffic:g}%"')
        attr = f" [{', '.join(edge_attrs)}]" if edge_attrs else ""
        lines.append(f"  gateway -> {root_id}{attr};")
    lines.append("}")
    return "\n".join(lines) + "\n"


def to_ascii(spec) -> str:
    """Terminal tree view of every predictor graph."""
    out: List[str] = [spec.name]

    def walk(unit, prefix: str, last: bool) -> None:
        branch = "└─ " if last else "├─ "
        detail = _node_detail(unit)
        line = f"{prefix}{branch}{unit.name} <{unit.type}"
        if detail:
            line += f": {detail}"
        line += ">"
        if unit.remote:
            line += " (remote)"
        out.append(line)
        child_prefix = prefix + ("   " if last else "│  ")
        for i, child in enumerate(unit.children):
            walk(child, child_prefix, i == len(unit.children) - 1)

    for pi, predictor in enumerate(spec.predictors):
        last_predictor = pi == len(spec.predictors) - 1
        extras = []
        if predictor.traffic:
            extras.append(f"{predictor.traffic:g}%")
        if predictor.shadow:
            extras.append("shadow")
        if predictor.hpa:
            extras.append("hpa")
        suffix = f" [{', '.join(extras)}]" if extras else ""
        glyph = "└─" if last_predictor else "├─"
        out.append(f"{glyph} predictor {predictor.name} (replicas={predictor.replicas}){suffix}")
        walk(predictor.graph, "   " if last_predictor else "│  ", True)
    return "\n".join(out) + "\n"


def main(argv: Optional[List[str]] = None) -> None:
    from seldon_core_tpu_torch.controlplane.spec import TpuDeployment

    parser = argparse.ArgumentParser(prog="seldon-tpu-torch-graph", description="render a deployment spec's inference graphs")
    parser.add_argument("spec", help="deployment spec yaml/json path")
    parser.add_argument("--format", choices=("ascii", "dot"), default="ascii")
    parser.add_argument("-o", "--output", default="", help="write to file instead of stdout")
    args = parser.parse_args(argv)

    spec = TpuDeployment.load(args.spec)
    text = to_dot(spec) if args.format == "dot" else to_ascii(spec)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        print(text, end="")


if __name__ == "__main__":
    main()
