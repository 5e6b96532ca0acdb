#!/usr/bin/env python3
"""The static int8 paths of the tree at TREE that run Q8 (the static int8
Dense kernel), on one GPU, for an A/B of trees in turns:

    python3 scripts/static_paths_in_turns.py TREE NAME [--build-only]

Run it for every tree in one command, in turns (parent, change, change,
parent; the parent unpacked by ``git archive``), since a host-timed window
moves from machine to machine; ``--build-only`` builds TREE's kernels and
exits, so that the trees can be built side by side first. TREE's own
package is imported; the measuring helpers (``graph_ms``, ``time_ms``)
are this checkout's ``chip_smoke.py``'s, so every tree is read the same
way. Weights are random, from seeds. Prints one line ``AB {json}``:

- VGG-16 at 112 pixels with an 8-class head (``chip_smoke.py``'s image
  int8 phase, untrained), fp32 and static int8 calibrated on 8 images:
  images/s at batch 32 over 16 device-resident batches with the
  read-back (best of 4 windows, the phase's measure), the device ms of
  one batch-32 forward (CUDA-graph replay) and Q8's launches in it;
- config A's scoring head (three Dense(4096, relu), Dense(8, softmax))
  fp32 and static int8: the device and the host (wall) ms of one
  forward at batch 32 and at batch 1, and records/s at batch 32;
- TextClassifier (cnn encoder at the class defaults, the 5000 x 200
  embedding seeded) static int8: the device and host ms of one batch-32
  forward and the records/s of ``predict`` on 8192 records (best of 3).
"""

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _harness():
    """This checkout's ``chip_smoke.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location("harness",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def vgg16(h, torch, np):
    from analytics_zoo_tpu_torch.models.image.imageclassification import \
        ImageClassifier
    from analytics_zoo_tpu_torch.ops.pallas.quantized import \
        KERNEL_INT8_STATIC
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    rng = np.random.default_rng(2)
    hw, batch, reps = h.IMG_HW, h.IMG_BATCH, h.IMG_REPS
    m = ImageClassifier("vgg-16", num_classes=h.IMG_CLASSES,
                        input_shape=(hw, hw, 3)).init_weights()
    xeval = rng.normal(size=(batch, hw, hw, 3)).astype(np.float32)
    xs = torch.from_numpy(np.stack([np.roll(xeval, i + 1, axis=0)
                                    for i in range(reps)])).cuda()
    models = {"fp32": InferenceModel().from_keras(m),
              "int8": InferenceModel().from_keras(m, quantize="int8",
                                                  calibrate=xeval[:8])}
    out = {}
    for mode, im in models.items():
        def many(stacked):
            return torch.stack([im._forward([xb]).argmax(-1)
                                for xb in stacked])
        with torch.no_grad():
            many(xs).cpu()
            best = 0.0
            for w in range(h.IMG_WINDOWS):
                xs_w = torch.roll(xs, w + 1, dims=1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                many(xs_w).cpu()
                best = max(best, reps * batch / (time.perf_counter() - t0))
            KERNEL_INT8_STATIC.reset()
            im._forward([xs[0]])
            torch.cuda.synchronize()
            q8 = KERNEL_INT8_STATIC.launches
            out[mode] = {"images_per_s": best, "q8_launches": q8,
                         "b32_device_ms": h.graph_ms(
                             lambda: im._forward([xs[0]]), iters=5)}
    return out


def config_a(h, torch, np):
    import copy

    from analytics_zoo_tpu_torch.pipeline.api.keras.engine import Sequential
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    d = h.HEAD_D
    fm = Sequential([Dense(d, activation="relu", input_shape=(d,)),
                     Dense(d, activation="relu"),
                     Dense(d, activation="relu"),
                     Dense(h.HEAD_CLASSES, activation="softmax")],
                    device="cuda").init_weights()
    host = copy.deepcopy(fm).to("cpu")
    host.device = torch.device("cpu")
    xf = np.random.default_rng(2).normal(size=(h.HEAD_ROWS, d)).astype(
        np.float32)
    ims = {"fp32": InferenceModel(device="cuda").from_keras(host),
           "int8_static": InferenceModel(device="cuda").from_keras(
               host, quantize="int8", calibrate=xf[:8])}
    out = {}
    for mode, im in ims.items():
        for rows in (32, 1):
            xb = torch.from_numpy(xf[:rows]).cuda()
            dev = h.graph_ms(lambda: im._forward([xb]))
            wall = h.time_ms(lambda: im._forward([xb]), iters=200)
            out[f"{mode}_b{rows}"] = {"device_ms": dev, "wall_ms": wall,
                                      "records_per_s": rows / (wall / 1e3)}
    return out


def text_classifier(h, torch, np):
    from analytics_zoo_tpu_torch.models.textclassification import \
        TextClassifier
    from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel
    rng = np.random.default_rng(21)
    table = (rng.normal(size=(h.TC_VOCAB, h.TC_DIM)) * 0.1).astype(
        np.float32)
    xs = rng.integers(1, h.TC_VOCAB, (h.TC_SERVE_ROWS["cnn"],
                                      h.TC_SEQ)).astype(np.int32)
    model = TextClassifier(h.TC_CLASSES, h.TC_DIM, h.TC_SEQ, "cnn",
                           h.TC_OUT, embedding_weights=table, device="cuda")
    model.init_weights()
    im = InferenceModel(device="cuda", max_batch_size=h.T_BATCH).from_keras(
        model, quantize="int8", calibrate=xs[:h.T_BATCH])
    chunk = torch.from_numpy(xs[:h.T_BATCH]).cuda()
    im.predict(xs[:h.T_BATCH])
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        im.predict(xs)
        best = max(best, len(xs) / (time.perf_counter() - t0))
    return {"b32_device_ms": h.graph_ms(lambda: im._forward([chunk])),
            "b32_wall_ms": h.time_ms(lambda: im._forward([chunk]),
                                     iters=200),
            "predict_records_per_s": best}


def main() -> int:
    root, name = os.path.abspath(sys.argv[1]), sys.argv[2]
    build_only = sys.argv[3:] == ["--build-only"]
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    from analytics_zoo_tpu_torch.common.context import init_zoo_context
    from analytics_zoo_tpu_torch.ops.cuda_build import build_all
    from analytics_zoo_tpu_torch.ops.pallas import quantized as pq
    if not torch.cuda.is_available():
        print("static_paths_in_turns: no CUDA device", file=sys.stderr)
        return 2
    build_all([pq.LIBRARY, pq.LIBRARY_CONV])
    if build_only:
        return 0
    h = _harness()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_zoo_context(conf={"zoo.compute.dtype": "float32", "zoo.seed": 0})
    torch.manual_seed(0)
    print("AB " + json.dumps({"tree": name,
                              "vgg16": vgg16(h, torch, np),
                              "config_a": config_a(h, torch, np),
                              "text_classifier": text_classifier(h, torch,
                                                                 np)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
