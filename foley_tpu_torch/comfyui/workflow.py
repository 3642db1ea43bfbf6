"""Litegraph workflow loader and executor on the port (``comfyui_adapter/workflow.py``
counterpart): runs ComfyUI workflow-JSON exports headlessly.

ComfyUI saves workflows as litegraph exports: ``nodes`` (with positional ``widgets_values``
and connection ``inputs`` carrying link ids) + ``links`` rows
``[link_id, src_node, src_slot, dst_node, dst_slot, type]``. This module executes such a
graph against :data:`foley_tpu_torch.comfyui.NODE_CLASS_MAPPINGS`, so the port's node pack
runs a workflow export of the reference unchanged (reference
``example_workflows/HunyuanVideoFoleyExample.json``).

Compatibility with the reference's node schemas (reference ``nodes.py:57-683``):
- connection-input names are aliased (``hunyuan_model`` -> ``foley_model`` etc.);
- widget values map positionally onto our INPUT_TYPES widget order, skipping litegraph
  ``control_after_generate`` values ('fixed'/'increment'/...) and dict-valued UI state;
- the reference's TorchCompile widgets (inductor backend knobs) do not apply: the port's
  node is the warm-up config; they are detected and replaced by its bucket defaults.

Non-foley node types (VHS video IO, PreviewAudio, ...) are delegated to caller-provided
``external`` handlers, or skipped when absent.
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

# reference input/connection names -> the nodes' names (reference nodes.py vs api/nodes.py)
INPUT_ALIASES = {
    "hunyuan_model": "foley_model",
    "hunyuan_deps": "dependencies",
    "vae_name": "vae_model",
    "synchformer_name": "synchformer_model",
}

# litegraph control_after_generate widget values (attached after INT seed widgets)
_CONTROL_VALUES = {"fixed", "increment", "decrement", "randomize"}

_WIDGET_TYPES = {"STRING", "INT", "FLOAT", "BOOLEAN"}


def load_workflow(path: str) -> Dict:
    with open(path) as f:
        graph = json.load(f)
    if "nodes" not in graph:
        raise ValueError(f"{path} is not a litegraph workflow export (no 'nodes')")
    return graph


def _widget_names(cls) -> List[str]:
    """Names of widget (non-connection) inputs in INPUT_TYPES declaration order."""
    schema = cls.INPUT_TYPES()
    names = []
    for section in ("required", "optional"):
        for name, spec in schema.get(section, {}).items():
            t = spec[0] if isinstance(spec, tuple) else spec
            # combo widgets are declared as a list of choices; primitives by type name
            if isinstance(t, list) or t in _WIDGET_TYPES:
                names.append(name)
    return names


def map_widgets(cls, widgets_values) -> Dict[str, Any]:
    """Positionally align a litegraph ``widgets_values`` array with ``cls``'s widgets.

    Tolerates: fewer values than widgets (reference nodes with fewer knobs — defaults apply),
    control_after_generate strings, and trailing UI-state dicts.
    """
    if isinstance(widgets_values, dict):  # some nodes export name-keyed widget state
        return {k: v for k, v in widgets_values.items() if not isinstance(v, dict)}
    names = _widget_names(cls)
    out: Dict[str, Any] = {}
    i = 0
    for value in widgets_values or []:
        if isinstance(value, str) and value in _CONTROL_VALUES:
            continue  # seed control widget, not an input
        if isinstance(value, dict):
            continue  # embedded UI state (video previews etc.)
        if i >= len(names):
            break
        out[names[i]] = value
        i += 1
    return out


def _is_reference_compile_widgets(values) -> bool:
    """Reference HunyuanFoleyTorchCompile widgets start with a dynamo backend name."""
    return bool(values) and isinstance(values[0], str) and values[0] in (
        "inductor", "cudagraphs", "eager", "aot_eager",
    )


def execute_workflow(
    graph: Dict,
    node_mappings: Optional[Dict[str, type]] = None,
    overrides: Optional[Dict[int, Dict[str, Any]]] = None,
    external: Optional[Dict[str, Callable]] = None,
) -> Dict[int, Tuple]:
    """Execute a litegraph export; returns {node_id: output tuple}.

    ``overrides[node_id]`` replaces mapped input values (checkpoint paths, step counts).
    ``external[node_type](node, inputs_dict)`` handles node types outside the foley pack;
    unhandled external nodes are skipped (their consumers see ``None`` inputs).
    """
    if node_mappings is None:
        from foley_tpu_torch import comfyui

        node_mappings = comfyui.NODE_CLASS_MAPPINGS
    overrides = overrides or {}
    external = external or {}

    nodes = {n["id"]: n for n in graph["nodes"]}
    # link_id -> (src_node, src_slot)
    link_src = {l[0]: (l[1], l[2]) for l in graph.get("links", [])}

    def deps_of(node) -> List[int]:
        out = []
        for slot in node.get("inputs", []) or []:
            lid = slot.get("link")
            if lid is not None and lid in link_src:
                out.append(link_src[lid][0])
        return out

    # topological order (graphs are small; Kahn via repeated sweep)
    order: List[int] = []
    done = set()
    pending = dict(nodes)
    while pending:
        progressed = False
        for nid in list(pending):
            if all(d in done for d in deps_of(pending[nid])):
                order.append(nid)
                done.add(nid)
                del pending[nid]
                progressed = True
        if not progressed:
            raise ValueError(f"workflow has a cycle among nodes {sorted(pending)}")

    results: Dict[int, Tuple] = {}
    for nid in order:
        node = nodes[nid]
        ntype = node["type"]
        # linked inputs by (aliased) slot name
        linked: Dict[str, Any] = {}
        for slot in node.get("inputs", []) or []:
            lid = slot.get("link")
            if lid is None or lid not in link_src:
                continue
            src, src_slot = link_src[lid]
            value = results.get(src)
            linked_name = INPUT_ALIASES.get(slot["name"], slot["name"])
            linked[linked_name] = value[src_slot] if value is not None else None

        if ntype not in node_mappings:
            handler = external.get(ntype)
            if handler is None:
                continue  # skipped external node
            results[nid] = tuple(handler(node, linked) or ())
            continue

        cls = node_mappings[ntype]
        widgets = node.get("widgets_values")
        if ntype == "HunyuanFoleyTorchCompile" and _is_reference_compile_widgets(widgets):
            widgets = []  # torch-dynamo knobs: the warm-up's bucket defaults apply
        kwargs = map_widgets(cls, widgets)
        kwargs = {INPUT_ALIASES.get(k, k): v for k, v in kwargs.items()}
        kwargs.update(linked)
        kwargs.update(overrides.get(nid, {}))
        known = set()
        for section in ("required", "optional"):
            known |= set(cls.INPUT_TYPES().get(section, {}))
        kwargs = {k: v for k, v in kwargs.items() if k in known}
        results[nid] = tuple(getattr(cls(), cls.FUNCTION)(**kwargs))
    return results
