"""TF SavedModel import — port of ``analytics_zoo_tpu/pipeline/api/
saved_model.py``: a SavedModel directory (graph + variables) as a
fine-tunable ``TFNet`` of torch ops.

Reference parity: ``TFNetForInference.scala:412``-scope loads SavedModels
*with variables intact* through a TF session and freezes them for
inference; the Python side is ``zoo.pipeline.api.net.TFNet.from_saved_model``.
Here there is no TF runtime: ``saved_model.pb`` (SavedModel → MetaGraphDef
→ GraphDef + SignatureDefs) is parsed with the in-repo wire codec, the
``variables/`` tensor bundle is read with ``utils/tensor_bundle.py``, and
each restored variable becomes a Const in the graph handed to ``TFNet`` —
where rank≥1 float values turn into TRAINABLE params, so an imported
SavedModel doesn't just serve, it fine-tunes (the capability the
reference's frozen session path never had).

Supported: TF1-style flat graphs (``tf.compat.v1`` Session export,
``simple_save``/``SavedModelBuilder``) with ref (``VariableV2``) or
resource (``VarHandleOp``/``ReadVariableOp``) variables. TF2
function-based SavedModels (compute hidden in FunctionDef libraries) are
rejected with a clear error — freeze those to a GraphDef first.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ...utils.proto import parse_fields
from ...utils.tensor_bundle import read_tensor_bundle
from .tfnet import TFNet, _decode_graph

__all__ = ["load_saved_model"]

_VAR_OPS = ("VariableV2", "Variable", "VarHandleOp")


def _decode_string(payload) -> str:
    return payload.decode("utf-8") if isinstance(payload, (bytes, bytearray)) \
        else str(payload)


def _parse_tensor_info(payload: bytes) -> str:
    """TensorInfo → tensor name ("x:0")."""
    name = ""
    for f, wt, p in parse_fields(payload):
        if f == 1:
            name = _decode_string(p)
    return name


def _parse_signature(payload: bytes) -> Dict[str, Dict[str, str]]:
    sig = {"inputs": {}, "outputs": {}, "method": ""}
    for f, wt, p in parse_fields(payload):
        if f in (1, 2) and isinstance(p, (bytes, bytearray)):
            key, name = "", ""
            for ff, _, pp in parse_fields(p):
                if ff == 1:
                    key = _decode_string(pp)
                elif ff == 2:
                    name = _parse_tensor_info(pp)
            sig["inputs" if f == 1 else "outputs"][key] = name
        elif f == 3:
            sig["method"] = _decode_string(p)
    return sig


def _parse_meta_graph(payload: bytes):
    tags: List[str] = []
    graph_def: Optional[bytes] = None
    signatures: Dict[str, Dict] = {}
    has_functions = False
    for f, wt, p in parse_fields(payload):
        if f == 1 and isinstance(p, (bytes, bytearray)):  # MetaInfoDef
            for ff, _, pp in parse_fields(p):
                if ff == 4:
                    tags.append(_decode_string(pp))
        elif f == 2 and isinstance(p, (bytes, bytearray)):
            graph_def = bytes(p)
            for ff, _, pp in parse_fields(p):
                if ff == 2 and isinstance(pp, (bytes, bytearray)) and pp:
                    # GraphDef.library (FunctionDefLibrary) with content
                    for fff, _, _ppp in parse_fields(pp):
                        if fff == 1:  # at least one FunctionDef
                            has_functions = True
        elif f == 5 and isinstance(p, (bytes, bytearray)):  # signature map
            key, val = "", None
            for ff, _, pp in parse_fields(p):
                if ff == 1:
                    key = _decode_string(pp)
                elif ff == 2:
                    val = _parse_signature(pp)
            if val is not None:
                signatures[key] = val
    return tags, graph_def, signatures, has_functions


def _base(tensor_name: str) -> str:
    return tensor_name.split(":")[0]


def load_saved_model(path: str, signature: str = "serving_default",
                     tags: Optional[List[str]] = None,
                     inputs: Optional[List[str]] = None,
                     outputs: Optional[List[str]] = None,
                     trainable: bool = True, device=None) -> TFNet:
    """Load ``path/saved_model.pb`` + ``path/variables/`` as a ``TFNet``.

    ``signature`` picks the SignatureDef naming the input/output tensors
    (override with explicit ``inputs``/``outputs`` node names); ``tags``
    picks among multiple MetaGraphs (default: the first, which is the only
    one ``simple_save``-style exports carry). Feed order follows the
    signature's sorted input keys. The weights sit on ``device``
    (``cuda`` unless given).
    """
    pb = os.path.join(path, "saved_model.pb")
    if not os.path.exists(pb):
        raise FileNotFoundError(f"{pb} not found — not a SavedModel dir?")
    with open(pb, "rb") as f:
        raw = f.read()

    metas = []
    for f_, wt, p in parse_fields(raw):
        if f_ == 2 and isinstance(p, (bytes, bytearray)):
            metas.append(_parse_meta_graph(bytes(p)))
    if not metas:
        raise ValueError(f"{pb}: no MetaGraphDef found")
    chosen = None
    if tags:
        for m in metas:
            if set(tags) <= set(m[0]):
                chosen = m
                break
        if chosen is None:
            raise ValueError(f"no MetaGraph tagged {tags}; available: "
                             f"{[m[0] for m in metas]}")
    else:
        chosen = metas[0]
    meta_tags, graph_bytes, signatures, has_functions = chosen
    if graph_bytes is None:
        raise ValueError(f"{pb}: MetaGraph has no GraphDef")

    nodes = _decode_graph(graph_bytes)
    if has_functions and not any(n["op"] in _VAR_OPS or n["op"] == "MatMul"
                                 for n in nodes):
        raise NotImplementedError(
            "TF2 function-based SavedModel (compute lives in FunctionDefs, "
            "main graph is empty) — export a TF1-style flat graph "
            "(tf.compat.v1 Session + simple_save) or freeze to a GraphDef")

    sig_inputs = sig_outputs = None
    if signatures:
        if signature not in signatures and (inputs is None or outputs is None):
            raise ValueError(f"signature {signature!r} not found; available: "
                             f"{sorted(signatures)}")
        if signature in signatures:
            sig = signatures[signature]
            sig_inputs = [_base(sig["inputs"][k])
                          for k in sorted(sig["inputs"])]
            sig_outputs = [_base(sig["outputs"][k])
                           for k in sorted(sig["outputs"])]
    feed = inputs or sig_inputs
    outs = outputs or sig_outputs
    if not feed or not outs:
        raise ValueError("SavedModel carries no usable signature; pass "
                         "inputs=[...] and outputs=[...] explicitly")

    # restore variables and substitute them as Consts
    bundle_prefix = os.path.join(path, "variables", "variables")
    variables: Dict[str, np.ndarray] = {}
    if os.path.exists(bundle_prefix + ".index"):
        variables = read_tensor_bundle(bundle_prefix)

    new_nodes = []
    for n in nodes:
        if n["op"] in _VAR_OPS:
            key = n["attrs"].get("shared_name") or n["name"]
            if isinstance(key, (bytes, bytearray)):
                key = key.decode("utf-8")
            if key not in variables and n["name"] in variables:
                key = n["name"]
            if key not in variables:
                raise ValueError(
                    f"variable node {n['name']!r} has no value in the "
                    f"bundle (keys: {sorted(variables)[:8]}...)")
            new_nodes.append({"name": n["name"], "op": "Const",
                              "inputs": [],
                              "attrs": {"value": variables[key]}})
        else:
            new_nodes.append(n)
    by_name = {n["name"]: n for n in new_nodes}

    # reachable slice from the outputs: drops Saver/Assign/init machinery
    # (whose ops the executor rightly refuses)
    keep = set()
    stack = [_base(o) for o in outs] + [_base(i) for i in feed]
    while stack:
        name = stack.pop()
        if name in keep or name not in by_name:
            continue
        keep.add(name)
        for raw_in in by_name[name]["inputs"]:
            if raw_in.startswith("^"):
                continue  # control deps don't pull Saver/init machinery in
            stack.append(_base(raw_in))
    sliced = [n for n in new_nodes if n["name"] in keep]
    # control-dep pruning: inputs starting with ^ may point outside the
    # slice (e.g. ^init) — drop those edges
    for n in sliced:
        n["inputs"] = [i for i in n["inputs"]
                       if not i.startswith("^") or i[1:] in keep]

    net = TFNet(sliced, inputs=feed, outputs=outs, trainable=trainable,
                device=device)
    net.signature = signatures.get(signature)
    return net
